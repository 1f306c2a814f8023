"""Simulator self-profiling: how fast is the event loop itself?  (PyTorch
port of ``repro/obs/profile.py``.)

The ROADMAP gates HBM-scale geometry sweeps on raw engine speed — the
event loop must get *measurably* faster before thousand-PE devices are
sweepable — and a speed target nobody measures is a speed target that
silently regresses.  An :class:`EngineProfile` attached to an
:class:`~repro_torch.core.engine.EngineSession` wall-clocks every ``advance``
and counts the loop's units of work:

* **events/sec** — executed tasks per wall-second, the engine-throughput
  headline ``benchmarks/obs.py`` records and guards with a floor;
* **heap operations** — ready-queue pushes and pops per advance (pops
  equal executed tasks; pushes are derived from the heap-size delta, so
  the hot loop carries no push counter);
* **claim-segment free-time probes** — how many token free-time slots the
  loop read while placing claims, the quantity the ROADMAP's
  vectorize-the-hot-path item needs a baseline for;
* **refresh windows** applied while advancing.

Profiling shares the engine's single observation branch with the trace
recorder: with neither attached the loop does no bookkeeping at all, and
with profiling attached no *scheduled* float changes — the profile reads
wall clocks, never virtual time.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AdvanceSample:
    """One profiled ``advance`` call."""

    wall_s: float
    n_exec: int              # tasks executed (== heap pops)
    heap_pushes: int
    token_probes: int        # token free-time reads while placing claims
    refresh_windows: int
    # fast-path counters (zero under the scalar differential engine):
    batches: int = 0         # vectorized frontier groups dispatched
    batched_tasks: int = 0   # tasks executed inside those groups
    vector_probes: int = 0   # token probes served by vectorized gathers
    heap_ops_avoided: int = 0  # pushes replaced by bulk frontier appends

    @property
    def events_per_sec(self) -> float:
        return self.n_exec / self.wall_s if self.wall_s > 0.0 else 0.0


@dataclasses.dataclass(frozen=True)
class AdmitSample:
    """One profiled ``admit``'s energy-bookkeeping cost.

    Energy accrues at admit time (it is schedule independent), so its
    entire metering overhead is admit-side — these samples make that cost
    observable and let ``benchmarks/obs.py`` keep asserting the
    recorded-vs-plain overhead bound with metering enabled.
    """

    wall_s: float            # time spent on energy bookkeeping alone
    n_tasks: int
    energy_entries: int      # per-task energy values appended


class EngineProfile:
    """Accumulates per-advance samples for one session (see module doc)."""

    #: search-oracle counter keys, in the order :meth:`summary` emits them
    ORACLE_KEYS = ("oracle_evals", "oracle_memo_hits", "oracle_cache_hits",
                   "oracle_cache_misses", "surrogate_prunes",
                   "oracle_batches", "oracle_workers")

    def __init__(self) -> None:
        self.samples: list[AdvanceSample] = []
        self.admit_samples: list[AdmitSample] = []
        self.oracle_counters = {k: 0 for k in self.ORACLE_KEYS}

    def add(self, sample: AdvanceSample) -> None:
        self.samples.append(sample)

    def record_admit(self, *, wall_s: float, n_tasks: int,
                     energy_entries: int) -> None:
        """Engine-facing hook: energy-accounting cost of one ``admit``."""
        self.admit_samples.append(AdmitSample(wall_s, n_tasks,
                                              energy_entries))

    def record_advance(self, *, wall_s: float, n_exec: int, heap_pushes: int,
                       token_probes: int, refresh_windows: int,
                       batches: int = 0, batched_tasks: int = 0,
                       vector_probes: int = 0,
                       heap_ops_avoided: int = 0) -> None:
        """Engine-facing hook: one sample per ``advance`` call."""
        self.samples.append(AdvanceSample(wall_s, n_exec, heap_pushes,
                                          token_probes, refresh_windows,
                                          batches, batched_tasks,
                                          vector_probes, heap_ops_avoided))

    def record_oracle(self, *, evals: int = 0, memo_hits: int = 0,
                      cache_hits: int = 0, cache_misses: int = 0,
                      prunes: int = 0, workers: int = 1) -> None:
        """Search-facing hook: one placement-oracle batch's bookkeeping.

        ``evals`` counts *full engine* evaluations (the costly unit the
        surrogate and the caches exist to avoid); ``prunes`` counts
        candidates discarded by the admissible lower bound; the hit
        counters split avoided evals between the in-memory memo and the
        persistent on-disk cache.  ``workers`` is the process-pool width
        the batch ran with (the max over batches is reported).
        """
        c = self.oracle_counters
        c["oracle_evals"] += evals
        c["oracle_memo_hits"] += memo_hits
        c["oracle_cache_hits"] += cache_hits
        c["oracle_cache_misses"] += cache_misses
        c["surrogate_prunes"] += prunes
        c["oracle_batches"] += 1
        c["oracle_workers"] = max(c["oracle_workers"], workers)

    # --- aggregates -------------------------------------------------------------

    @property
    def n_advances(self) -> int:
        return len(self.samples)

    @property
    def wall_s(self) -> float:
        return sum(s.wall_s for s in self.samples)

    @property
    def n_exec(self) -> int:
        return sum(s.n_exec for s in self.samples)

    @property
    def events_per_sec(self) -> float:
        w = self.wall_s
        return self.n_exec / w if w > 0.0 else 0.0

    def summary(self) -> dict:
        """Deterministic-keyed aggregate (ready for a BENCH artifact)."""
        n = self.n_exec
        return {
            "n_advances": self.n_advances,
            "n_exec": n,
            "wall_s": self.wall_s,
            "events_per_sec": self.events_per_sec,
            "heap_pushes": sum(s.heap_pushes for s in self.samples),
            "heap_pops": n,
            "token_probes": sum(s.token_probes for s in self.samples),
            "token_probes_per_task": (
                sum(s.token_probes for s in self.samples) / n if n else 0.0),
            "refresh_windows": sum(s.refresh_windows for s in self.samples),
            "batched_dispatches": sum(s.batches for s in self.samples),
            "batched_tasks": sum(s.batched_tasks for s in self.samples),
            "batched_frac": (
                sum(s.batched_tasks for s in self.samples) / n if n else 0.0),
            "mean_batch_size": (
                sum(s.batched_tasks for s in self.samples)
                / max(1, sum(s.batches for s in self.samples))),
            "vector_probes": sum(s.vector_probes for s in self.samples),
            "heap_ops_avoided": sum(s.heap_ops_avoided
                                    for s in self.samples),
            "n_admits": len(self.admit_samples),
            "admit_energy_wall_s": sum(s.wall_s
                                       for s in self.admit_samples),
            "energy_entries": sum(s.energy_entries
                                  for s in self.admit_samples),
            **{k: self.oracle_counters[k] for k in self.ORACLE_KEYS},
        }
