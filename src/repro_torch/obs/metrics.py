"""Counter / gauge / histogram registry + schedule-derived resource metrics
(PyTorch port of ``repro/obs/metrics.py``).

The serving and batch layers expose *what happened* as aggregates; this
module gives them a small, dependency-free metrics vocabulary:

* :class:`Counter`   — monotonic event counts (jobs arrived, cells swept);
* :class:`Gauge`     — a timestamped series of instantaneous values
  (queue depth, lease occupancy) that keeps its full timeline, because the
  interesting serving phenomena — queueing collapse past saturation, lease
  fragmentation — are *shapes*, not endpoints;
* :class:`Histogram` — value distributions (latency, makespan) summarized
  by count / mean / min / max / percentiles.

A :class:`MetricsRegistry` names them (create-on-first-use) and snapshots
deterministically, so whole sweep grids can aggregate one registry across
every :class:`~repro_torch.device.batch.BatchRunner` cell and every
:class:`~repro_torch.runtime.serve.ServingRuntime` run.

Schedule-derived metrics live here too: :func:`utilization` folds a
:class:`~repro_torch.obs.trace.Recorder`'s claim events into per-resource busy
fractions (one value per token track — the timeline the Chrome trace
renders, reduced to numbers a guard can assert on), and
:func:`slo_attainment` computes per-tenant SLO attainment over serving
results.

Everything here is host arithmetic on Python floats; percentiles, means and
the gauge's weighted mean are NumPy's, as in the reference, so every
summary equals the reference's to the last bit (``torch.quantile`` is not
guaranteed to).
"""

from __future__ import annotations

import numpy as np


class Counter:
    """Monotonic count (integer events or accumulated float quantities)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError(f"counters only go up; got inc({n})")
        self.value += n


class Gauge:
    """Timestamped series of instantaneous values (full timeline kept)."""

    __slots__ = ("_series",)

    def __init__(self) -> None:
        self._series: list[tuple[float, float]] = []

    def record(self, t_ns: float, value: float) -> None:
        self._series.append((t_ns, value))

    @property
    def last(self) -> float | None:
        return self._series[-1][1] if self._series else None

    @property
    def peak(self) -> float | None:
        return max(v for _, v in self._series) if self._series else None

    def series(self) -> list[tuple[float, float]]:
        return list(self._series)

    def time_weighted_mean(self) -> float:
        """Mean value weighted by how long each value was held.

        The series is a step function (each value holds until the next
        timestamp); a plain mean over-weights bursts of rapid updates.
        """
        s = self._series
        if len(s) < 2:
            return float(s[0][1]) if s else 0.0
        ts = np.asarray([t for t, _ in s], dtype=np.float64)
        vs = np.asarray([v for _, v in s], dtype=np.float64)
        dt = np.diff(ts)
        span = ts[-1] - ts[0]
        if span <= 0.0:
            return float(vs.mean())
        return float((vs[:-1] * dt).sum() / span)


class Histogram:
    """Value distribution summarized on demand (raw samples kept)."""

    __slots__ = ("_values",)

    def __init__(self) -> None:
        self._values: list[float] = []

    def observe(self, value: float) -> None:
        self._values.append(value)

    #: below this many samples a percentile is reported but flagged
    #: unreliable — interpolating an empty or one-point series yields
    #: either nothing or a constant, not a distribution statistic
    MIN_RELIABLE_SAMPLES = 2

    @property
    def n(self) -> int:
        return len(self._values)

    def percentile(self, p: float) -> tuple[float | None, bool]:
        """``(value, reliable)`` — guarded against degenerate series.

        An empty series returns ``(None, False)`` instead of raising or
        producing NaN; a series below :data:`MIN_RELIABLE_SAMPLES` returns
        its value with ``reliable=False`` so guards can skip rather than
        assert on noise.
        """
        if not self._values:
            return None, False
        a = np.asarray(self._values, dtype=np.float64)
        return (float(np.percentile(a, p)),
                len(a) >= self.MIN_RELIABLE_SAMPLES)

    def summary(self, percentiles=(50.0, 95.0, 99.0)) -> dict:
        if not self._values:
            return {"n": 0, "reliable": False}
        a = np.asarray(self._values, dtype=np.float64)
        out = {"n": len(a), "reliable": len(a) >= self.MIN_RELIABLE_SAMPLES,
               "mean": float(a.mean()),
               "min": float(a.min()), "max": float(a.max())}
        for p in percentiles:
            out[f"p{p:g}"] = float(np.percentile(a, p))
        return out


class MetricsRegistry:
    """Named counters/gauges/histograms, created on first use."""

    def __init__(self) -> None:
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram()
        return h

    def snapshot(self) -> dict:
        """Deterministic nested dict of everything recorded (sorted keys).

        Gauges report last / peak / time-weighted mean plus the series
        length (the full series stays on the Gauge for callers that plot).
        """
        return {
            "counters": {k: c.value
                         for k, c in sorted(self._counters.items())},
            "gauges": {k: {"last": g.last, "peak": g.peak,
                           "mean": g.time_weighted_mean(),
                           "n": len(g._series)}
                       for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(self._histograms.items())},
        }


# --- schedule-derived metrics ----------------------------------------------------


def utilization(recorder, *, span_ns: float | None = None) -> dict[str, float]:
    """Busy fraction per resource track from a recorder's claim events.

    Claims on one token never overlap (the engine serializes each token's
    free time), so per-token busy time is a plain sum of claim durations;
    the denominator is ``span_ns`` (defaults to the last claim end, i.e.
    the recorded makespan).  Refresh windows count as busy time on their
    bank's refresh track, not on the PE tracks — refresh occupancy and
    compute occupancy stay separately observable.
    """
    s = recorder._session
    if s is None:
        raise ValueError("recorder was never attached to a session")
    model = s.model
    names = model.token_names()
    exec_plan = s._exec_plan
    busy = np.zeros(len(names), dtype=np.float64)
    t_end = 0.0
    for pos, t0, t1 in recorder._tasks:
        p = exec_plan[pos]
        lp = len(p)
        if lp == 2:
            busy[p[0]] += t1 - t0
        elif lp == 3:
            for rid in p[0]:
                busy[rid] += t1 - t0
        if t1 > t_end:
            t_end = t1
    from repro_torch.core.engine import CIRCUIT
    for pos, k, leg, t0, t1 in recorder._segs:
        seg = exec_plan[pos][0][k]
        rids = seg[1] if seg[0] == CIRCUIT else seg[1 + leg]
        for rid in rids:
            busy[rid] += t1 - t0
        if t1 > t_end:
            t_end = t1
    refresh_busy: dict[int, float] = {}
    for unit, t0, t1 in recorder._refresh:
        refresh_busy[unit] = refresh_busy.get(unit, 0.0) + (t1 - t0)
        if t1 > t_end:
            t_end = t1
    span = span_ns if span_ns is not None else t_end
    if span <= 0.0:
        return {}
    out = {name: float(busy[i] / span) for i, name in enumerate(names)}
    runit_names = model.refresh_unit_names()
    for unit, b in sorted(refresh_busy.items()):
        out[runit_names[unit]] = b / span
    return out


def energy_attribution(recorder, *, job_tenants: dict | None = None) -> dict:
    """Per-job (and optionally per-tenant) joules from a recorded session.

    Direct energy — compute ops and moves, including every shared-bus hop
    a move's price already folds in — is charged to the job that executed
    the task (the job occupying the bus window, since claim segments give
    each window exactly one owner).  Refresh energy is background: each
    applied tRFC window's joules are split equally among the jobs live at
    the window's start (admitted, not yet finished); windows with no live
    job accrue to ``unattributed_j``.

    Returns ``{"per_job_j", "refresh_j", "unattributed_j", "total_j"}``
    plus ``"per_tenant_j"`` when ``job_tenants`` maps job ids to tenant
    names (jobs absent from the map roll up under ``"-"``).  Totals
    reconcile: executed direct energy + refresh == ``total_j``.
    """
    s = recorder._session
    if s is None:
        raise ValueError("recorder was never attached to a session")
    task_energy = s._task_energy
    job_of = s._job_of
    per_job: dict[int, float] = {}
    # ops and single-segment moves record into _tasks; multi-segment moves
    # record one row per (segment, leg) into _segs — dedupe on position
    for pos, _t0, _t1 in recorder._tasks:
        j = job_of[pos]
        per_job[j] = per_job.get(j, 0.0) + task_energy[pos]
    for pos in {seg[0] for seg in recorder._segs}:
        j = job_of[pos]
        per_job[j] = per_job.get(j, 0.0) + task_energy[pos]
    # refresh windows, split across the jobs live at window start
    e_window = s.model.energy_table().refresh_window_j
    refresh_j = unattributed = 0.0
    if recorder._refresh:
        admits = s._job_admit
        fins = s._job_fin
        rem = s._job_rem
        n_jobs = len(admits)
        for _unit, t0, _t1 in recorder._refresh:
            live = [j for j in range(n_jobs)
                    if admits[j] <= t0 and (rem[j] or fins[j] >= t0)]
            refresh_j += e_window
            if not live:
                unattributed += e_window
                continue
            share = e_window / len(live)
            for j in live:
                per_job[j] = per_job.get(j, 0.0) + share
    out = {
        "per_job_j": {j: e for j, e in sorted(per_job.items())},
        "refresh_j": refresh_j,
        "unattributed_j": unattributed,
        "total_j": sum(per_job.values()) + unattributed,
    }
    if job_tenants is not None:
        per_tenant: dict[str, float] = {}
        for j, e in per_job.items():
            t = job_tenants.get(j, "-")
            per_tenant[t] = per_tenant.get(t, 0.0) + e
        out["per_tenant_j"] = dict(sorted(per_tenant.items()))
    return out


def slo_attainment(results, slo_ns: float) -> dict[str, dict]:
    """Per-tenant SLO attainment over serving :class:`JobResult` rows.

    Returns ``{tenant: {"n_jobs", "attained", "attainment"}}`` where
    ``attainment`` is the fraction of the tenant's jobs whose latency met
    ``slo_ns``.  Deterministic ordering (sorted tenant names).
    """
    if slo_ns <= 0.0:
        raise ValueError(f"slo_ns must be > 0, got {slo_ns}")
    per: dict[str, list[float]] = {}
    for r in results:
        per.setdefault(r.tenant, []).append(r.latency_ns)
    return {
        tenant: {"n_jobs": len(ls),
                 "attained": sum(1 for v in ls if v <= slo_ns),
                 "attainment": sum(1 for v in ls if v <= slo_ns) / len(ls)}
        for tenant, ls in sorted(per.items())}
