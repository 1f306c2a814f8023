"""Schedule tracing: an opt-in event recorder + Chrome-trace export (PyTorch
port of ``repro/obs/trace.py``).

The paper's claims are *timeline* claims — Shared-PIM keeps computing while
rows are in flight, LISA stalls its spans — yet every result type in this
repo is an end-of-run aggregate.  A :class:`Recorder` attached to an
:class:`~repro_torch.core.engine.EngineSession` captures the schedule as it
executes — task dispatch/finish, per-token claim-segment occupancy,
refresh windows, job admit/complete — and the serving layer adds lease
grant/release, arrivals, and queue depth on top.  :meth:`Recorder.dump`
exports the whole thing as Chrome trace-event JSON (loadable at
https://ui.perfetto.dev) with **one track per resource token** — every
bank PE, BK-bus, tx/rx shared row, group bus, and channel bus of the
model's token layout — plus per-bank refresh tracks and per-job /
per-tenant serving tracks.

Recording is strictly opt-in and strictly *observational*: the engine's
event loop appends raw ``(task, start, end)`` tuples while it runs and the
recorder expands them into trace events only at export time, reading the
claimed tokens back out of the session's compiled plan.  No float the
scheduler computes is touched, so a recorded schedule is bit-for-bit the
unrecorded one (``chip_smoke.py``'s ``pim-runtime`` phase asserts this on
the card and times the recording's overhead).  The engines store Python
floats in the recorder — one ``.tolist()`` a batch, never a sync a task —
so a trace recorded on the card is the same bytes as one recorded on the
host.

Exported traces are reproducible provenance, not just pictures: the
metadata block carries each admitted graph's :func:`graph_fingerprint`,
the interconnect mode, and (when the caller provides one) the pass
pipeline's rewrite log.  Export is byte-deterministic — stable event
ordering, stable float formatting — so two recordings of the same
configuration diff clean (``tests/test_torch_pim_obs.py`` pins this,
and holds the bytes to the reference's).
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from repro_torch.core.ir import graph_fingerprint  # noqa: F401  (one definition)


class Recorder:
    """Opt-in schedule recorder (see module docstring).

    Pass one to :class:`~repro_torch.core.engine.EngineSession` (or to
    :class:`~repro_torch.runtime.serve.ServingRuntime`, which forwards it).  The
    engine appends raw tuples to the ``_tasks`` / ``_segs`` / ``_refresh``
    / ``_jobdone`` stores; the serving runtime appends to the serving-event
    stores.  All expansion work happens in :meth:`chrome_trace`.
    """

    def __init__(self) -> None:
        self._session = None
        # engine-driven stores (appended inside the hot loop: keep raw)
        self._tasks: list = []       # (pos, start_ns, end_ns)
        self._segs: list = []        # (pos, seg_idx, leg, start_ns, end_ns)
        self._refresh: list = []     # (unit, start_ns, end_ns)
        self._admits: list = []      # (job, at_ns, n_tasks, fingerprint)
        self._jobdone: list = []     # (job, finish_ns)
        # serving-driven stores (appended between advances: cold path)
        self._arrivals: list = []    # (t_ns, tenant, seq)
        self._leases: list = []      # (ticket, banks, t0_ns, t1_ns|None, who)
        self._lease_open: dict = {}  # ticket -> index into _leases
        self._queue_depth: list = [] # (t_ns, depth)

    # --- attachment -------------------------------------------------------------

    def attach(self, session) -> None:
        """Bind to the session whose schedule this recorder captures."""
        if self._session is not None and self._session is not session:
            raise ValueError(
                "Recorder is already attached to another EngineSession; "
                "use one recorder per session")
        self._session = session

    @property
    def n_events(self) -> int:
        return (len(self._tasks) + len(self._segs) + len(self._refresh)
                + len(self._arrivals) + len(self._queue_depth)
                + sum(1 for le in self._leases if le[3] is not None))

    # --- serving-side hooks (cold path, called between advances) ---------------

    def arrival(self, t_ns: float, tenant: str, seq: int) -> None:
        self._arrivals.append((t_ns, tenant, seq))

    def lease_grant(self, ticket: int, banks: tuple, t_ns: float,
                    who: str) -> None:
        self._lease_open[ticket] = len(self._leases)
        self._leases.append([ticket, tuple(banks), t_ns, None, who])

    def lease_release(self, ticket: int, t_ns: float) -> None:
        idx = self._lease_open.pop(ticket, None)
        if idx is not None:
            self._leases[idx][3] = t_ns

    def queue_depth(self, t_ns: float, depth: int) -> None:
        self._queue_depth.append((t_ns, depth))

    # --- power timelines --------------------------------------------------------

    def power_series(self, *, windows: int = 120,
                     window_ns: float | None = None) -> dict:
        """Windowed instantaneous power per bank/bus group, plus the total.

        Each executed task's metered joules (the session's admit-time
        ``_task_energy``) are apportioned over its recorded claim windows
        — multi-segment moves by each segment's token-ns share, so a
        Shared-PIM transit leg's energy lands on the bus tracks during the
        transit window — and refresh windows charge the bank they refresh.
        The deposits are then integrated into ``windows`` equal time bins
        (or bins of ``window_ns`` when given) and converted to watts.

        Returns ``{"window_ns", "n_windows", "groups": {name: [W, ...]},
        "total_w": [W, ...]}`` with only groups that drew any energy; the
        derivation is pure arithmetic over recorded data, so it is
        deterministic and byte-stable in the exported trace.
        """
        s = self._session
        if s is None:
            raise ValueError("recorder was never attached to a session")
        model = s.model
        exec_plan = s._exec_plan
        task_energy = s._task_energy
        gnames: list[str] = []
        gidx: dict[str, int] = {}

        def _gid(name: str) -> int:
            i = gidx.get(name)
            if i is None:
                i = gidx[name] = len(gnames)
                gnames.append(name)
            return i

        tok_g = [_gid(g) for g in model.token_power_groups()]
        runit_g = [_gid(n.split("/", 1)[1] if n.startswith("refresh/")
                        else n)
                   for n in model.refresh_unit_names()]

        # deposits: (group, t0, t1, joules)
        deposits: list[tuple[int, float, float, float]] = []
        t_end = 0.0
        for pos, t0, t1 in self._tasks:
            p = exec_plan[pos]
            e = task_energy[pos]
            if len(p) == 2:
                deposits.append((tok_g[p[0]], t0, t1, e))
            else:
                share = e / len(p[0])
                for rid in p[0]:
                    deposits.append((tok_g[rid], t0, t1, share))
            if t1 > t_end:
                t_end = t1
        # multi-segment moves: split the move's energy across its recorded
        # claim windows by token-ns weight, then equally across each
        # window's tokens (transit legs thereby charge the buses they hold)
        from repro_torch.core.engine import CIRCUIT
        by_pos: dict[int, list] = {}
        for row in self._segs:
            by_pos.setdefault(row[0], []).append(row)
        for pos, rows in by_pos.items():
            e = task_energy[pos]
            rids_of = []
            weights = []
            for _pos, k, leg, t0, t1 in rows:
                seg = exec_plan[pos][0][k]
                rids = seg[1] if seg[0] == CIRCUIT else seg[1 + leg]
                rids_of.append(rids)
                weights.append((t1 - t0) * len(rids))
                if t1 > t_end:
                    t_end = t1
            wsum = sum(weights)
            for (_pos, _k, _leg, t0, t1), rids, w in zip(rows, rids_of,
                                                         weights):
                ew = e * (w / wsum) if wsum > 0.0 else e / len(rows)
                share = ew / len(rids)
                for rid in rids:
                    deposits.append((tok_g[rid], t0, t1, share))
        e_window = model.energy_table().refresh_window_j
        for unit, t0, t1 in self._refresh:
            deposits.append((runit_g[unit], t0, t1, e_window))
            if t1 > t_end:
                t_end = t1

        if not deposits or t_end <= 0.0:
            return {"window_ns": 0.0, "n_windows": 0, "groups": {},
                    "total_w": []}
        wns = window_ns if window_ns is not None else t_end / windows
        if wns <= 0.0:
            raise ValueError(f"window_ns must be > 0, got {wns}")
        n_bins = int(t_end / wns)
        if n_bins * wns < t_end:
            n_bins += 1
        bins = [[0.0] * n_bins for _ in gnames]
        last = n_bins - 1
        for gi, t0, t1, e in deposits:
            if t1 <= t0:
                b = int(t0 / wns)
                bins[gi][b if b < last else last] += e
                continue
            rate = e / (t1 - t0)
            b = int(t0 / wns)
            while t0 < t1 and b < n_bins:
                bend = (b + 1) * wns
                seg_end = t1 if t1 < bend else bend
                bins[gi][b] += rate * (seg_end - t0)
                t0 = seg_end
                b += 1
        to_w = 1e9 / wns    # J per window -> W
        groups = {}
        total = [0.0] * n_bins
        for gi, name in enumerate(gnames):
            series = bins[gi]
            if not any(series):
                continue
            groups[name] = [v * to_w for v in series]
            for b, v in enumerate(series):
                total[b] += v * to_w
        return {"window_ns": wns, "n_windows": n_bins, "groups": groups,
                "total_w": total}

    # --- export -----------------------------------------------------------------

    def chrome_trace(self, metadata: dict | None = None, *,
                     power_windows: int = 120) -> dict:
        """Expand the recorded schedule into a Chrome trace-event dict.

        Layout: pid 0 = engine resource tokens (one tid per token, named
        from the model's ``token_names``; refresh units follow on their own
        tids), pid 1 = jobs (one tid per admitted job), pid 2 = serving
        (arrivals, queue-depth counter, one lease track per bank), pid 3 =
        power (one counter track per bank/bus group that drew energy, plus
        the device total, from :meth:`power_series` with ``power_windows``
        bins; ``power_windows=0`` disables the power tracks).
        """
        s = self._session
        if s is None:
            raise ValueError("recorder was never attached to a session")
        model = s.model
        names = model.token_names()
        n_res = len(names)
        exec_plan = s._exec_plan
        guids = s._guids
        job_of = s._job_of
        ev: list[dict] = []

        def span(pid, tid, name, t0, t1, **args):
            ev.append({"ph": "X", "pid": pid, "tid": tid, "name": name,
                       "ts": t0 / 1e3, "dur": (t1 - t0) / 1e3,
                       "args": args} if args else
                      {"ph": "X", "pid": pid, "tid": tid, "name": name,
                       "ts": t0 / 1e3, "dur": (t1 - t0) / 1e3})

        # engine tracks: expand each executed task's claims onto its tokens
        for pos, t0, t1 in self._tasks:
            p = exec_plan[pos]
            lp = len(p)
            uid, job = guids[pos], job_of[pos]
            if lp == 2:
                span(0, p[0], f"op u{uid}", t0, t1, job=job)
            elif lp == 3:
                for rid in p[0]:
                    span(0, rid, f"move u{uid}", t0, t1, job=job)
            # lp == 1 (multi-segment): claims recorded per segment below
        from repro_torch.core.engine import CIRCUIT
        for pos, k, leg, t0, t1 in self._segs:
            seg = exec_plan[pos][0][k]
            uid, job = guids[pos], job_of[pos]
            if seg[0] == CIRCUIT:
                rids, label = seg[1], f"move u{uid}"
            else:
                rids = seg[1 + leg]
                label = f"move u{uid}/{('drain', 'transit', 'fill')[leg]}"
            for rid in rids:
                span(0, rid, label, t0, t1, job=job)
        runit_names = model.refresh_unit_names()
        for unit, t0, t1 in self._refresh:
            span(0, n_res + unit, "refresh", t0, t1)

        # job tracks: admit instants + admit->finish spans
        fins = dict(self._jobdone)
        for job, at, n_tasks, fp in self._admits:
            ev.append({"ph": "i", "pid": 1, "tid": job, "name": "admit",
                       "ts": at / 1e3, "s": "t",
                       "args": {"n_tasks": n_tasks, "fingerprint": fp}})
            fin = fins.get(job)
            if fin is not None:
                span(1, job, f"job {job}", at, fin, n_tasks=n_tasks)

        # serving tracks
        for t, tenant, seq in self._arrivals:
            ev.append({"ph": "i", "pid": 2, "tid": 0,
                       "name": f"arrive {tenant}#{seq}", "ts": t / 1e3,
                       "s": "t"})
        for t, depth in self._queue_depth:
            ev.append({"ph": "C", "pid": 2, "tid": 1, "name": "queue_depth",
                       "ts": t / 1e3, "args": {"depth": depth}})
        lease_banks = sorted({b for le in self._leases for b in le[1]})
        lease_tid = {b: 2 + i for i, b in enumerate(lease_banks)}
        for ticket, banks, t0, t1, who in self._leases:
            if t1 is None:
                continue          # lease still open at export: no span yet
            for b in banks:
                span(2, lease_tid[b], f"lease {who}", t0, t1, ticket=ticket)

        # power counter tracks: one per bank/bus group + the device total
        power_names: list[str] = []
        if power_windows:
            ps = self.power_series(windows=power_windows)
            wns = ps["window_ns"]
            for tid, (gname, series) in enumerate(
                    sorted(ps["groups"].items())):
                power_names.append(f"power/{gname}")
                for b, w in enumerate(series):
                    ev.append({"ph": "C", "pid": 3, "tid": tid,
                               "name": "power", "ts": b * wns / 1e3,
                               "args": {"W": w}})
            if ps["total_w"]:
                tid = len(power_names)
                power_names.append("power/device-total")
                for b, w in enumerate(ps["total_w"]):
                    ev.append({"ph": "C", "pid": 3, "tid": tid,
                               "name": "power", "ts": b * wns / 1e3,
                               "args": {"W": w}})

        # canonical ordering: raw stores are appended in execution order,
        # which is deterministic, but sort anyway so the byte layout never
        # depends on which store an event came from
        ev.sort(key=lambda e: (e["ts"], e["pid"], e["tid"], e["name"],
                               e.get("dur", 0.0)))

        # track-name metadata (after the sort: metadata leads the file)
        meta_ev: list[dict] = []
        for pid, pname in ((0, "engine"), (1, "jobs"), (2, "serving"),
                           (3, "power")):
            meta_ev.append({"ph": "M", "pid": pid, "name": "process_name",
                            "args": {"name": pname}})
        for tid, name in enumerate(names):
            meta_ev.append({"ph": "M", "pid": 0, "tid": tid,
                            "name": "thread_name", "args": {"name": name}})
        for unit, name in enumerate(runit_names):
            meta_ev.append({"ph": "M", "pid": 0, "tid": n_res + unit,
                            "name": "thread_name", "args": {"name": name}})
        for job, _at, _n, _fp in self._admits:
            meta_ev.append({"ph": "M", "pid": 1, "tid": job,
                            "name": "thread_name",
                            "args": {"name": f"job{job}"}})
        meta_ev.append({"ph": "M", "pid": 2, "tid": 0, "name": "thread_name",
                        "args": {"name": "arrivals"}})
        meta_ev.append({"ph": "M", "pid": 2, "tid": 1, "name": "thread_name",
                        "args": {"name": "queue"}})
        for b in lease_banks:
            meta_ev.append({"ph": "M", "pid": 2, "tid": lease_tid[b],
                            "name": "thread_name",
                            "args": {"name": f"lease/bank{b}"}})
        for tid, name in enumerate(power_names):
            meta_ev.append({"ph": "M", "pid": 3, "tid": tid,
                            "name": "thread_name", "args": {"name": name}})

        other = {
            "interconnect": model.mode.value,
            "jobs": [{"job": job, "admit_ns": at, "n_tasks": n,
                      "graph_fingerprint": fp}
                     for job, at, n, fp in self._admits],
        }
        if metadata:
            other.update(metadata)
        return {"traceEvents": meta_ev + ev, "displayTimeUnit": "ns",
                "otherData": other}

    def dump(self, path: str | Path, metadata: dict | None = None, *,
             power_windows: int = 120) -> Path:
        """Write the Chrome trace as byte-deterministic JSON; returns path.

        ``sort_keys`` plus compact separators plus Python's canonical float
        ``repr`` make the bytes a pure function of the recorded schedule —
        traces of the same configuration diff clean across runs and PRs.
        """
        path = Path(path)
        blob = json.dumps(self.chrome_trace(metadata,
                                            power_windows=power_windows),
                          sort_keys=True, separators=(",", ":"))
        path.write_text(blob)
        return path


def rewrite_log_metadata(logs: dict) -> dict:
    """Serialize ``{key: RewriteLog}`` into trace-metadata provenance."""
    out = {}
    for key, log in sorted(logs.items(), key=lambda kv: str(kv[0])):
        out[str(key)] = {"summary": log.summary(),
                         "rewrites": [str(e) for e in log.entries]}
    return {"rewrite_logs": out}


def record_sweep(cfg, *, refresh=None,
                 device: str | torch.device = "cuda") -> Recorder:
    """Record one :class:`~repro_torch.device.batch.SweepConfig` cell's schedule.

    Builds the cell's placed (and optionally optimized) graph exactly the
    way :class:`~repro_torch.device.batch.BatchRunner` would, runs it through a
    fresh recorded :class:`~repro_torch.core.engine.EngineSession` on
    ``device`` (``cuda`` unless the caller asks for the CPU; there is no
    fallback), and returns the recorder (dump with cell metadata already
    attached via :meth:`Recorder.dump`).  Deterministic: two calls with the
    same config produce byte-identical trace JSON, on either device.
    """
    from repro_torch.core import ir
    from repro_torch.core.engine import EngineSession
    from repro_torch.device import partition
    from repro_torch.device.resources import DeviceModel

    if cfg.opt:
        struct = partition.optimized_struct(
            cfg.app, cfg.geometry, policy=cfg.policy, scaling=cfg.scaling,
            opt=cfg.opt, **cfg.kwargs)
    else:
        struct = partition.partitioned_struct(
            cfg.app, cfg.geometry, policy=cfg.policy, scaling=cfg.scaling,
            **cfg.kwargs)
    g = ir.materialize(struct, cfg.mode)
    rec = Recorder()
    session = EngineSession(DeviceModel(cfg.mode, cfg.geometry),
                            refresh=refresh, recorder=rec, device=device)
    session.admit(g)
    session.advance()
    return rec
