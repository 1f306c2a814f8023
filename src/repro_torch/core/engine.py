"""Resource-token discrete-event engine shared by every scheduler layer
(PyTorch port of ``repro/core/engine.py``).

The paper's thesis is that interconnects differ only in *what a move
occupies while in flight*: LISA links the bitlines of every subarray it
crosses (compute stalls), Shared-PIM claims two shared-row tokens plus the
BK-bus (compute continues).  This module turns that observation into the
simulator's architecture: **all** interconnect semantics — single-bank LISA
spans, Shared-PIM tx/rx tokens and broadcast, device-level bank-group and
channel buses — are expressed as declarative *claim segments* over a flat
array of resource tokens, and one event loop executes them.

A :class:`ResourceModel` compiles a :class:`~repro_torch.core.ir.TaskGraph`
into a :class:`Compiled` plan: for each op the resource token it occupies,
and for each move a tuple of segments, each either

* **circuit-switched** (:data:`CIRCUIT`): claim every listed token for the
  segment's whole duration — LISA's semantics, intra-bank and cross-bank
  alike.  Tokens flagged as stalled PEs accrue stall time.
* **store-and-forward** (:data:`SAF`): three pipelined legs (drain /
  transit / fill) that each hold only their own tokens for their own
  window — Shared-PIM's semantics for cross-bank streams.

The event loop lives in :class:`EngineSession`, an *incremental* list
scheduler: task graphs are admitted (possibly mid-flight, at any virtual
time, with uid-offset splicing into the live ready state), the session is
advanced to a time horizon, and per-job completion times are reported as
jobs drain.  Ready tasks are ordered by a **total** priority key
``(-critical_path, ready_time, uid)`` — the final ``uid`` component makes
tie-breaking deterministic by construction.  The critical-path priorities
are computed by a *levelized* sweep (:func:`critical_path`) on the session's
device: tasks are bucketed by topological depth and each level's
longest-path values are reduced in one segmented maximum.

A session runs on a device (``cuda`` unless the caller asks for the CPU;
asking for ``cuda`` without a card raises).  Under the default
``engine="vector"`` the plan's CSR arrays and the critical path live
there, and wide batches run there on device copies of the token free
times and the per-task ready times, in-degrees and finish times, whose
record is kept on the host, where batches of at most ``SCALAR_K`` run
(:mod:`repro_torch.core.engine_vec`); the ready frontier is a Python list
on the host.  ``engine="scalar"`` is the differential oracle: its loop
runs on the host in Python floats.

DRAM refresh is expressed in the same vocabulary as moves: a
:class:`RefreshSpec` turns each bank's token block (the model's
``refresh_units``) into a *periodic* CIRCUIT claim — every ``interval_ns``
the unit's tokens are claimed for ``duration_ns``, so compute, Shared-PIM
copies, and refresh contend through the ordinary free-time machinery rather
than special-case code.  A session without a spec never touches the refresh
path.

The one-shot :func:`run` is a thin wrapper — one session, one graph admitted
at t=0, advanced to completion — and reproduces the legacy schedulers
bit-for-bit (the golden schedules pin it): accounting accumulates in the
same order and with the same float operations the legacy code used, down
to the per-span stall subtotals.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Sequence

import torch

from repro_torch.core import copy_models
from repro_torch.core import energy as energy_model
from repro_torch.core.energy import move_energy
from repro_torch.core.ir import OP, TaskGraph, graph_fingerprint
from repro_torch.core.pluto import Interconnect
from repro_torch.device import resolve

#: move-segment archetypes (first element of every segment tuple)
CIRCUIT, SAF = 0, 1

_F64 = torch.float64
_I64 = torch.int64


# --- cached per-row transfer latencies ------------------------------------------
# The legacy schedulers re-derived CopyResult dataclasses for every move on
# every pop; the per-row coefficients depend only on (mechanism, distance /
# fan-out), so they are memoized here once per process.

_LISA_ROW_NS: dict[int, float] = {}
_SP_BCAST_NS: dict[int, float] = {}
_SP_ROW_NS: float | None = None


def _lisa_row_ns(dist: int) -> float:
    lat = _LISA_ROW_NS.get(dist)
    if lat is None:
        lat = _LISA_ROW_NS[dist] = \
            copy_models.lisa_copy(distance=dist).latency_ns
    return lat


def _sp_row_ns() -> float:
    global _SP_ROW_NS
    if _SP_ROW_NS is None:
        _SP_ROW_NS = copy_models.sharedpim_copy().latency_ns
    return _SP_ROW_NS


def _sp_bcast_ns(fanout: int) -> float:
    lat = _SP_BCAST_NS.get(fanout)
    if lat is None:
        lat = _SP_BCAST_NS[fanout] = copy_models.sharedpim_broadcast(
            dests=tuple(range(1, fanout + 1))).latency_ns
    return lat


def move_latency(mode: Interconnect, src: int, dsts: Sequence[int],
                 rows: int) -> float:
    """Contention-free latency of one move (identical to the legacy model).

    LISA: one serial distance-priced copy per destination.  Shared-PIM:
    distance independent; broadcasts amortize tRAS across <=4 destinations
    per bus transaction.
    """
    if mode is Interconnect.LISA:
        total = 0.0
        for d in dsts:
            dist = abs(d - src)
            if dist < 1:
                dist = 1
            total += rows * _lisa_row_ns(dist)
        return total
    if len(dsts) == 1:
        return rows * _sp_row_ns()
    lat = 0.0
    remaining = list(dsts)
    while remaining:
        grp = remaining[:4]
        remaining = remaining[4:]
        lat += rows * _sp_bcast_ns(len(grp))
    return lat


# --- compiled plans -------------------------------------------------------------


@dataclasses.dataclass
class Compiled:
    """Everything the event loop needs, precomputed as flat Python lists.

    ``exec_plan`` holds one pre-bound tuple per task, dispatched on length:
    ``(rid, duration)`` for an op (2); ``(rids, stall_counts, dur)`` for the
    common single-segment intra-bank move (3); ``(segments,)`` for the
    general multi-segment move (1).

    Integer schedule statistics — task counts, rows delivered, rows per
    route class, cross-move count — are order independent, so they are
    summed here at compile time instead of inside the event loop; only the
    float accumulators (busy/stall/energy), whose rounding depends on
    accumulation order, stay in the loop.

    Segment tuples (one move = one or more segments, executed in order, all
    floored at the move's dependency-ready time):

    ``(CIRCUIT, rids, stall_counts, dur, busy_keys, energy_j)``
        claim every token in ``rids`` for ``dur`` ns.  ``stall_counts``
        groups the stalled-PE tokens: each group's stall time is subtotaled
        before accumulating (bit-compatible with the legacy span
        accounting).  Each key in ``busy_keys`` accrues the segment span.

    ``(SAF, leg1, leg2, leg3, drain, transit, fill, drain1, transit1,
    fill1, mb, busy_keys, energy_j)``
        store-and-forward: leg *k+1* may start one per-row time
        (``drain1``/``transit1``) after leg *k* starts; the final delivery
        ends no earlier than one per-row fill (``fill1``) after transit
        ends.  ``mb`` is the move-busy charge (sum of leg durations).
    """

    n_resources: int
    exec_plan: list         # per-task execution tuple (see above)
    prio_dur: list          # float priority duration per task
    n_ops: int = 0
    n_moves: int = 0
    n_rows: int = 0         # rows x fan-out, summed over moves
    n_cross: int = 0        # moves with at least one off-bank destination
    rows_by_route: dict = dataclasses.field(default_factory=dict)
    #: metered joules per task (ops at op_j, moves fully priced) — derived
    #: accounting only, summed at admit time like the integer stats and
    #: apportioned over claim windows by the obs layer; the event loops
    #: never read it
    task_energy_j: list = dataclasses.field(default_factory=list,
                                            compare=False, repr=False)
    energy_op_j: float = 0.0    # sum of op entries in task_energy_j
    energy_move_j: float = 0.0  # sum of move entries in task_energy_j
    #: lazily-built structure-of-arrays view of ``exec_plan`` (token-id /
    #: CSR arrays), cached here per device by
    #: :mod:`repro_torch.core.engine_vec`
    soa: object = dataclasses.field(default=None, compare=False, repr=False)


class ResourceModel:
    """Compiles a TaskGraph onto a concrete set of resource tokens."""

    mode: Interconnect

    def compile(self, g: TaskGraph) -> Compiled:
        raise NotImplementedError

    def n_resources(self) -> int:
        """Size of the token array (graph independent, per model)."""
        raise NotImplementedError

    def refresh_units(self) -> tuple[tuple[int, ...], ...]:
        """Token sets refreshed together — one tuple per DRAM bank.

        A :class:`RefreshSpec` turns each unit into a periodic CIRCUIT claim
        over exactly these tokens; models without refreshable storage (none
        in this repo) may return an empty tuple.
        """
        raise NotImplementedError

    def token_names(self) -> tuple[str, ...]:
        """Human-readable name per resource token (trace track labels).

        The observability layer renders one trace track
        per token; the default generic names work for any model, concrete
        models override with their real layout (PE / bus / shared-row).
        """
        return tuple(f"token{r}" for r in range(self.n_resources()))

    def refresh_unit_names(self) -> tuple[str, ...]:
        """Name per refresh unit (one trace track each, same order)."""
        return tuple(f"refresh/unit{u}"
                     for u in range(len(self.refresh_units())))

    def bus_classes(self) -> tuple[str, ...]:
        """Bus-busy accounting classes this model's segments may charge.

        Sessions initialize their ``bus_busy_ns`` dict from this, so a
        model that introduces a new transit class (e.g. the fleet tier's
        ``"d2d"`` links) grows the accounting without perturbing results
        recorded by models that never charge it.
        """
        return ("bank_group", "channel")

    def energy_table(self) -> energy_model.EnergyTable:
        """Per-op-class / per-hop price list used to meter this model.

        Purely observational: compile() prices each task's joules from it
        and sessions sum them at admit time — no scheduled float depends
        on these values.  Both concrete models share the Table II prices.
        """
        return energy_model.DEFAULT_TABLE

    def token_power_groups(self) -> tuple[str, ...]:
        """Power-track group per token (one Perfetto counter track each).

        Defaults to the token name's ``/``-prefix, which collapses a
        device bank's ~50 tokens into one ``bankN`` track while each
        group/channel/d2d bus keeps its own; single-bank models override.
        """
        return tuple(n.split("/")[0] for n in self.token_names())


class BankModel(ResourceModel):
    """One DRAM bank: ``n_pes`` subarray PEs plus the intra-bank interconnect.

    Token layout: PE ``p`` -> ``p``; BK-bus -> ``n_pes``; transmit shared row
    of ``p`` -> ``n_pes + 1 + p``; receive shared row -> ``2*n_pes + 1 + p``.

    * LISA move: one CIRCUIT segment claiming every PE token in
      ``[min(src, *dsts), max(src, *dsts)]`` — computation there stalls.
    * Shared-PIM move: one CIRCUIT segment claiming the bus, the source tx
      token and each destination's rx token — PEs keep computing.
    """

    def __init__(self, mode: Interconnect, n_pes: int = 16):
        self.mode = mode
        self.n_pes = n_pes
        # app graphs repeat a handful of (src, dsts, rows) move signatures
        # thousands of times; compiled segments are pure in those
        # coordinates, so memoize per signature (keyed on the RAW ids — the
        # priority latency is priced on them, pre-wrap)
        self._move_cache: dict = {}

    def n_resources(self) -> int:
        return 3 * self.n_pes + 1

    def refresh_units(self) -> tuple[tuple[int, ...], ...]:
        # one bank: every PE, the BK-bus and all shared-row tokens sit in
        # the refreshing array, so a refresh claims the whole block
        return (tuple(range(3 * self.n_pes + 1)),)

    def token_names(self) -> tuple[str, ...]:
        n = self.n_pes
        return (tuple(f"pe{p}" for p in range(n)) + ("bk-bus",)
                + tuple(f"tx{p}" for p in range(n))
                + tuple(f"rx{p}" for p in range(n)))

    def refresh_unit_names(self) -> tuple[str, ...]:
        return ("refresh/bank0",)

    def token_power_groups(self) -> tuple[str, ...]:
        # every token of a single-bank model draws from the same bank
        return ("bank0",) * self.n_resources()

    def compile(self, g: TaskGraph) -> Compiled:
        n_pes = self.n_pes
        mode = self.mode
        lisa = mode is Interconnect.LISA
        bus = n_pes
        tx0 = n_pes + 1
        rx0 = 2 * n_pes + 1
        move_cache = self._move_cache

        src = g.src.tolist()
        rows = g.rows.tolist()
        dst_indptr = g.dst_indptr.tolist()
        dst_flat = g.dst_flat.tolist()

        # ops vectorized: PE token per op, duration-as-priority; move slots
        # are overwritten below
        prio: list = g.duration.tolist()
        exec_plan: list = list(zip((g.pe % n_pes).tolist(), prio))
        e_op = self.energy_table().op_j
        task_energy: list = [e_op] * g.n
        energy_move = 0.0
        move_idx = torch.nonzero(g.kinds != OP).flatten().tolist()
        n_rows = 0
        for i in move_idx:
            lo_, hi_ = dst_indptr[i], dst_indptr[i + 1]
            raw_dsts = dst_flat[lo_:hi_]
            r = rows[i]
            # int vs tuple keys cannot collide, so single-destination moves
            # skip the tuple allocation
            key = (src[i], raw_dsts[0] if hi_ - lo_ == 1 else tuple(raw_dsts),
                   r)
            hit = move_cache.get(key)
            if hit is None:
                s = src[i] % n_pes
                dsts = [d % n_pes for d in raw_dsts]
                lat = move_latency(mode, s, dsts, r)
                if lisa:
                    lo = min(s, *dsts) if dsts else s
                    hi = max(s, *dsts) if dsts else s
                    rids = tuple(range(lo, hi + 1))
                    stall_counts = (hi - lo + 1,)
                else:
                    rids = (bus, tx0 + s, *(rx0 + d for d in dsts))
                    stall_counts = ()
                hit = move_cache[key] = (
                    (rids, stall_counts, lat),
                    move_latency(mode, src[i], raw_dsts, r),
                    r * len(dsts),
                    move_energy(mode, s, dsts, r))
            exec_plan[i], prio[i], n_del, me = hit
            n_rows += n_del
            task_energy[i] = me
            energy_move += me
        n_moves = len(move_idx)
        n_ops = g.n - n_moves
        return Compiled(3 * n_pes + 1, exec_plan, prio,
                        n_ops=n_ops, n_moves=n_moves, n_rows=n_rows,
                        n_cross=0,
                        rows_by_route={"intra": n_rows} if n_moves else {},
                        task_energy_j=task_energy,
                        energy_op_j=n_ops * e_op,
                        energy_move_j=energy_move)


# --- levelized critical path -----------------------------------------------------


def _dev_key(device: torch.device) -> str:
    return str(torch.device(device))


def critical_path(g: TaskGraph, prio_dur: Sequence[float],
                  device: str | torch.device = "cpu") -> torch.Tensor:
    """Longest path to a sink per task, swept level by level on ``device``.

    Bit-identical to the legacy per-task recursion: longest path is a pure
    (max, +) computation, and IEEE max/add are order independent here.
    Returns a float64 tensor on ``device``.
    """
    dev = torch.device(device)
    n = g.n
    cp = torch.tensor(prio_dur, dtype=_F64)
    if n == 0:
        return cp.to(dev)
    depth = g.levels()
    succ_indptr, succ_flat = g.successors()
    order = torch.argsort(depth, stable=True)
    maxd = int(depth[order[-1]])
    if n < 8 * (maxd + 1):
        # deep, narrow graph (serial chains): per-level vector overhead
        # exceeds the work, so run the reverse-topological sweep in plain
        # Python — same (max, +) recurrence, identical floats
        cp_l = cp.tolist()
        si = succ_indptr.tolist()
        sf = succ_flat.tolist()
        for i in reversed(order.tolist()):
            s0, s1 = si[i], si[i + 1]
            if s0 != s1:
                m = cp_l[sf[s0]]
                for k in range(s0 + 1, s1):
                    v = cp_l[sf[k]]
                    if v > m:
                        m = v
                cp_l[i] += m
        return torch.tensor(cp_l, dtype=_F64, device=dev)
    # the gather plan per level is pure structure — compute once per graph
    # and device (shared via _derived across every mode/materialization)
    key = ("cp_plan", _dev_key(dev))
    plan = g._derived.get(key)
    if plan is None:
        bounds = torch.searchsorted(depth[order],
                                    torch.arange(maxd + 2, dtype=_I64))
        plan = []
        for d in range(maxd, -1, -1):
            sel = order[bounds[d]:bounds[d + 1]]
            starts = succ_indptr[sel]
            counts = succ_indptr[sel + 1] - starts
            total = int(counts.sum())
            if total == 0:
                continue
            seg_starts = torch.cumsum(counts, 0) - counts
            within = torch.arange(total, dtype=_I64) \
                - torch.repeat_interleave(seg_starts, counts)
            gather = succ_flat[torch.repeat_interleave(starts, counts)
                               + within]
            nz = torch.nonzero(counts > 0).flatten()
            # each gathered value's segment among the non-empty segments,
            # over which the reference takes np.maximum.reduceat
            seg = torch.repeat_interleave(
                torch.arange(len(nz), dtype=_I64), counts[nz])
            plan.append((sel.to(dev), gather.to(dev), seg.to(dev),
                         nz.to(dev), len(nz)))
        g._derived[key] = plan
    cp = cp.to(dev)
    for sel, gather, seg, nz, n_nz in plan:
        mx = torch.zeros(n_nz, dtype=_F64, device=dev).scatter_reduce_(
            0, seg, cp[gather], "amax", include_self=False)
        m = torch.zeros(len(sel), dtype=_F64, device=dev)
        m[nz] = mx
        cp[sel] += m
    return cp


# --- refresh --------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RefreshSpec:
    """Periodic per-bank refresh, expressed as engine-level CIRCUIT claims.

    Every ``interval_ns`` (tREFI) each refresh unit — one DRAM bank's whole
    token block, as reported by the model's ``refresh_units`` — is claimed
    for ``duration_ns`` (tRFC): compute ops, moves, and the refresh contend
    through the ordinary token free-time machinery, no special cases.  With
    ``stagger`` (the JEDEC per-bank refresh pattern) bank ``b`` of ``k`` is
    phase-shifted by ``b/k`` of an interval so the whole device never blinks
    at once.

    A claim fires when the schedule frontier (the dependency-ready time of
    the task about to execute) passes its due time; like real controllers,
    a refresh may start late when the bank is still busy — it then pushes
    everything behind it.  Defaults are DDR4 8Gb values.
    """

    interval_ns: float = 7800.0      # tREFI
    duration_ns: float = 350.0       # tRFC
    stagger: bool = True

    def __post_init__(self) -> None:
        if self.interval_ns <= 0.0:
            raise ValueError(f"interval_ns must be > 0, got {self.interval_ns}")
        if not 0.0 <= self.duration_ns < self.interval_ns:
            raise ValueError(
                f"duration_ns must lie in [0, interval_ns); got "
                f"{self.duration_ns} vs interval {self.interval_ns}")


# --- the event loop -------------------------------------------------------------


@dataclasses.dataclass
class EngineStats:
    """Raw schedule outcome; shims wrap it into their public result types."""

    makespan_ns: float
    op_busy_ns: float
    move_busy_ns: float
    stall_ns: float
    n_ops: int
    n_moves: int
    n_rows_moved: int
    n_cross_moves: int
    energy_j: float                 # cross-segment (drain+transit) energy
    rows_by_route: dict
    bus_busy_ns: dict
    finish_times: dict              # uid -> finish ns
    #: bank-ns spent refreshing: one applied window = one bank (refresh
    #: unit) claimed for duration_ns; divide by n_banks * makespan for the
    #: per-bank refresh duty cycle
    refresh_ns: float = 0.0
    #: applied refresh windows (refresh_ns / duration_ns, counted exactly)
    n_refresh_windows: int = 0
    # --- metered energy (derived accounting; never a schedule input) ---
    #: joules of PE compute (n_ops x the model's per-op price)
    op_energy_j: float = 0.0
    #: joules of data movement, fully priced per move (drain + every
    #: transit hop + fill delivery) — unlike ``energy_j``, which keeps the
    #: legacy loop-accrued cross-segment subtotal the goldens pin
    move_energy_j: float = 0.0
    #: joules of refresh (applied windows x refresh_window_j)
    refresh_energy_j: float = 0.0

    @property
    def total_energy_j(self) -> float:
        """Everything metered: compute + movement + refresh."""
        return self.op_energy_j + self.move_energy_j + self.refresh_energy_j


@dataclasses.dataclass(frozen=True)
class JobRecord:
    """Lifecycle of one admitted graph inside an :class:`EngineSession`."""

    job: int                # session-assigned job id (admission order)
    admit_ns: float         # virtual time the graph was admitted
    uid_offset: int         # added to the graph's uids inside the session
    n_tasks: int
    remaining: int          # unexecuted tasks (0 = complete)
    finish_ns: float        # max task finish so far; final when remaining==0
    #: direct metered joules of this job's own tasks (compute + moves);
    #: shared-bus and refresh energy are apportioned separately by
    #: the obs layer's energy attribution
    energy_j: float = 0.0

    @property
    def done(self) -> bool:
        return self.remaining == 0


class EngineSession:
    """Incremental event engine: admit graphs mid-flight, advance to horizons.

    A session owns one :class:`ResourceModel`'s token array for its whole
    lifetime.  :meth:`admit` splices a new task graph into the live ready
    state — per-task arrays are appended at a position base, dependency
    positions are rebased, and uids are offset so jobs cannot collide —
    and :meth:`advance` runs the list scheduler until the ready queue
    drains or every pending task's ready time reaches the horizon.
    Completion times are reported per job, which is what the serving
    runtime's latency accounting consumes.

    Horizon semantics: ``advance(until)`` stops *before* executing the
    highest-priority ready task whose dependency-ready time is ``>= until``
    — scheduling decisions at or beyond the horizon are deferred until the
    caller has admitted whatever arrives there, so a higher-priority
    arrival can win resources from work that had not yet been committed.

    With a :class:`RefreshSpec`, each refresh unit's periodic claim is
    applied as the schedule frontier passes its due times, through the same
    token free-time updates a CIRCUIT move uses.

    One session + one graph admitted at t=0 + one full advance reproduces
    :func:`run` bit-for-bit (same pop order, same float accumulation
    order); ``run`` *is* that wrapper.  Per-task state is retained for the
    session's lifetime (finish times are part of the result contract), so
    a session's footprint grows with total admitted tasks.

    ``engine`` selects the event-loop implementation: ``"vector"`` (the
    default) runs the batched loop in :mod:`repro_torch.core.engine_vec`,
    its wide batches over per-task tensors on the session's ``device``
    (``free`` is a float64 tensor there, a copy of the host record
    ``_h_free``); ``"scalar"`` runs the plain-Python loop below
    over host lists.  Both produce bit-identical schedules — the scalar
    loop is the differential oracle the vectorized path is tested against.

    ``device`` is ``cuda`` unless the caller asks for the CPU; asking for
    ``cuda`` on a host without a card raises (there is no fallback).  The
    critical path of every admitted graph is computed there, under both
    engines.
    """

    def __init__(self, model: ResourceModel, *,
                 refresh: RefreshSpec | None = None,
                 validate: bool = True,
                 recorder=None, profile=None,
                 engine: str = "vector",
                 device: str | torch.device = "cuda"):
        if engine not in ("vector", "scalar"):
            raise ValueError(
                f"engine must be 'vector' or 'scalar', got {engine!r}")
        self.device = resolve(device)
        self.engine = engine
        self.model = model
        self.refresh = refresh
        self._validate = validate
        # opt-in observability (the obs layer): a recorder captures the
        # schedule as raw event tuples, a profile wall-clocks the loop.
        # Both are observational only and duck-typed — no scheduled float
        # changes whether they are attached or not.
        self.recorder = recorder
        self.profile = profile
        if recorder is not None:
            recorder.attach(self)
        self.free = [0.0] * model.n_resources()
        self.now = 0.0
        self._heap: list = []
        # per-task state, indexed by global position (job base + local pos)
        self._exec_plan: list = []
        self._neg_cp: list = []
        self._succ: list = []
        self._indeg: list = []
        self._ready_t: list = []
        self._finish: list = []
        self._guids: list = []
        self._job_of: list = []
        # per-job state
        self._job_admit: list = []
        self._job_off: list = []
        self._job_n: list = []
        self._job_rem: list = []
        self._job_fin: list = []
        self._completed_backlog: list = []
        self._n_live = 0
        self._next_uid = 0
        # float accounting (legacy accumulation order preserved)
        self._op_busy = self._move_busy = self._stall = self._energy = 0.0
        self._bus_busy = {k: 0.0 for k in model.bus_classes()}
        self._refresh_ns = 0.0
        self._n_refresh = 0
        # integer statistics (order independent, summed at admit time)
        self._n_ops = self._n_moves = self._n_rows = self._n_cross = 0
        self._rows_by_route: dict = {}
        # metered energy: like the integer stats it is order independent
        # and schedule independent, so it accrues at admit time — the
        # event loops never touch it (energy is derived, never steering)
        self._op_energy = self._move_energy = 0.0
        self._task_energy: list = []
        self._job_energy: list = []
        self._rq: list = []          # (due_ns, unit, tokens) refresh heap
        if refresh is not None:
            units = model.refresh_units()
            k = max(1, len(units))
            for u, tokens in enumerate(units):
                phase = refresh.interval_ns * u / k if refresh.stagger else 0.0
                heapq.heappush(self._rq,
                               (phase + refresh.interval_ns, u, tokens))
        if engine == "vector":
            # deferred import: engine_vec imports CIRCUIT/Compiled from here
            from repro_torch.core import engine_vec
            self._vec = engine_vec
            engine_vec.init_state(self)
        else:
            self._vec = None

    # --- introspection ----------------------------------------------------------

    @property
    def n_jobs(self) -> int:
        return len(self._job_admit)

    @property
    def n_pending_tasks(self) -> int:
        return self._n_live

    def job(self, job: int) -> JobRecord:
        return JobRecord(job, self._job_admit[job], self._job_off[job],
                         self._job_n[job], self._job_rem[job],
                         self._job_fin[job], self._job_energy[job])

    # --- admission --------------------------------------------------------------

    def admit(self, g: TaskGraph, *, at: float = 0.0,
              uid_offset: int | None = None) -> int:
        """Splice ``g`` into the live schedule at virtual time ``at``.

        Returns the job id.  ``uid_offset`` defaults to 0 for the first
        job and to the smallest shift that keeps uids collision-free for
        later ones; session-facing uids are ``graph uid + offset``.
        """
        if self._validate:
            g.validate()
        n = g.n
        vec = self._vec
        if vec is not None:
            # the whole per-graph derivation — compile, critical path, min
            # successor priorities — is pure in (model, graph), so repeated
            # admits of a cached app graph (the serving frontend's steady
            # state) reuse it.  Guards: the model strong ref defeats id()
            # reuse, and the graph identity check matters because _derived
            # is *shared* across same-skeleton placements (the batch
            # runner's policy cells), whose compiled plans differ
            # the device-resident parts (the minimum successor priorities)
            # are keyed by device as well
            ck = ("admit_cache", id(self.model), _dev_key(self.device))
            entry = g._derived.get(ck)
            if entry is None or entry[0] is not self.model \
                    or entry[1] is not g:
                comp = self.model.compile(g)
                neg = -critical_path(g, comp.prio_dur, self.device)
                si_, sf_ = g.successors()
                m_local = vec.min_succ_neg_cp(si_.to(self.device),
                                              sf_.to(self.device), neg)
                entry = g._derived[ck] = (
                    self.model, g, comp, neg.tolist(), m_local,
                    m_local.tolist())
            _, _, comp, neg_list, m_local, m_list = entry
            static = g._derived.get("vec_static")
            if static is None:
                src_sel = torch.nonzero(torch.diff(g.dep_indptr) == 0)
                static = g._derived["vec_static"] = (
                    g.uids.tolist(), src_sel.flatten().tolist())
            uids, sources = static
        else:
            comp = self.model.compile(g)
            neg_list = (-critical_path(g, comp.prio_dur,
                                       self.device)).tolist()
            static = g._derived.get("loop_static")
            if static is None:
                succ_indptr, succ_flat = g.successors()
                si = succ_indptr.tolist()
                sf = succ_flat.tolist()
                succ = [sf[si[i]:si[i + 1]] for i in range(n)]
                uids = g.uids.tolist()
                base_indeg = torch.diff(g.dep_indptr).tolist()
                sources = [i for i in range(n) if not base_indeg[i]]
                # positional uids admit offset-free splicing at base 0
                pos_uids = uids == list(range(n))
                static = g._derived["loop_static"] = (succ, uids, base_indeg,
                                                      sources, pos_uids)
            succ, uids, base_indeg, sources, _pos_uids = static
        if uid_offset is None:
            uid_offset = 0 if not self._job_admit \
                else self._next_uid - (int(g.uids.min()) if n else 0)

        base = len(self._exec_plan)
        job = len(self._job_admit)
        self._exec_plan.extend(comp.exec_plan)
        self._neg_cp.extend(neg_list)
        if vec is not None:
            vec.admit_state(self, g, comp, at, base, m_local, m_list)
        else:
            if base == 0:
                # the cached successor lists are position-correct as-is;
                # they are shared read-only
                self._succ.extend(succ)
            else:
                self._succ.extend([x + base for x in lst] for lst in succ)
            self._indeg.extend(base_indeg)
            self._ready_t.extend([at] * n)
            self._finish.extend([0.0] * n)
        self._guids.extend(uids if uid_offset == 0
                           else [u + uid_offset for u in uids])
        self._job_of.extend([job] * n)
        self._job_admit.append(at)
        self._job_off.append(uid_offset)
        self._job_n.append(n)
        self._job_rem.append(n)
        self._job_fin.append(at)
        self._n_live += n
        if n:
            self._next_uid = max(self._next_uid,
                                 uid_offset + int(g.uids.max()) + 1)
        else:
            self._completed_backlog.append(job)
        self._n_ops += comp.n_ops
        self._n_moves += comp.n_moves
        self._n_rows += comp.n_rows
        self._n_cross += comp.n_cross
        for route, rows in comp.rows_by_route.items():
            self._rows_by_route[route] = \
                self._rows_by_route.get(route, 0) + rows
        # energy bookkeeping (admit-time, wall-clocked when profiling so
        # the metering overhead is itself observable)
        _e_wall0 = time.perf_counter() if self.profile is not None else 0.0
        te = comp.task_energy_j
        if len(te) != n:          # models that do not meter: charge zero
            te = [0.0] * n
        self._task_energy.extend(te)
        self._op_energy += comp.energy_op_j
        self._move_energy += comp.energy_move_j
        self._job_energy.append(comp.energy_op_j + comp.energy_move_j)
        if self.profile is not None:
            self.profile.record_admit(
                wall_s=time.perf_counter() - _e_wall0,
                n_tasks=n, energy_entries=len(te))
        heap, neg_cp, guids = self._heap, self._neg_cp, self._guids
        if vec is not None:
            # the vectorized frontier is a sorted list, not a binary heap:
            # append unsorted and let advance() re-sort adaptively
            heap.extend((neg_cp[base + i], at, guids[base + i], base + i)
                        for i in sources)
            self._heap_dirty = True
        else:
            heappush = heapq.heappush
            for i in sources:
                gi = base + i
                heappush(heap, (neg_cp[gi], at, guids[gi], gi))
        if self.recorder is not None:
            self.recorder._admits.append((job, at, n, graph_fingerprint(g)))
            if n == 0:
                self.recorder._jobdone.append((job, at))
        return job

    # --- the event loop ---------------------------------------------------------

    def advance(self, until: float | None = None, *,
                stop_on_completion: bool = False) -> list[int]:
        """Run the list scheduler up to ``until`` (None = drain everything).

        Returns the job ids that completed during this call, in completion
        (execution) order.  With ``stop_on_completion`` the call returns as
        soon as at least one job has completed — the serving runtime uses
        this so freed bank leases re-admit queued work *before* the rest of
        the in-flight schedule is committed, letting the admitted job
        compete for resources on critical-path priority.

        ``engine="vector"`` sessions (the default) dispatch to the batched
        loop in :mod:`repro_torch.core.engine_vec`; the scalar loop below is
        the
        differential oracle and produces bit-identical schedules.
        """
        if self._vec is not None:
            return self._vec.advance(self, until,
                                     stop_on_completion=stop_on_completion)
        return self._advance_scalar(until,
                                    stop_on_completion=stop_on_completion)

    def _advance_scalar(self, until: float | None = None, *,
                        stop_on_completion: bool = False) -> list[int]:
        hz = float("inf") if until is None else until
        heap = self._heap
        free = self.free
        exec_plan = self._exec_plan
        ready_t = self._ready_t
        finish = self._finish
        succ = self._succ
        indeg = self._indeg
        neg_cp = self._neg_cp
        guids = self._guids
        job_of = self._job_of
        job_rem = self._job_rem
        job_fin = self._job_fin
        rq = self._rq
        spec = self.refresh
        op_busy = self._op_busy
        move_busy = self._move_busy
        stall = self._stall
        energy = self._energy
        bus_busy = self._bus_busy
        refresh_ns = self._refresh_ns
        n_refresh = self._n_refresh
        completed = self._completed_backlog
        self._completed_backlog = []
        n_exec = 0

        # opt-in observability: one shared branch per executed task; with
        # neither a recorder nor a profile attached the loop below touches
        # none of this (and no scheduled float changes either way)
        rec = self.recorder
        prof = self.profile
        observe = rec is not None or prof is not None
        rec_tasks = rec._tasks if rec is not None else None
        rec_segs = rec._segs if rec is not None else None
        probes = 0
        if prof is not None:
            _wall0 = time.perf_counter()
            _heap0 = len(heap)
            _refresh0 = n_refresh

        heappush, heappop = heapq.heappush, heapq.heappop
        while heap:
            if completed and stop_on_completion:
                break
            if heap[0][1] >= hz:
                break
            i = heappop(heap)[3]
            dep_t = ready_t[i]
            if rq and rq[0][0] <= dep_t:
                # the schedule frontier passed refresh due times: apply each
                # unit's CIRCUIT claim (floored at its due time) and requeue
                rint = spec.interval_ns
                rdur = spec.duration_ns
                while rq and rq[0][0] <= dep_t:
                    due, u, toks = heappop(rq)
                    s = due
                    for r in toks:
                        f = free[r]
                        if f > s:
                            s = f
                    e = s + rdur
                    for r in toks:
                        free[r] = e
                    refresh_ns += rdur
                    n_refresh += 1
                    if rec is not None:
                        rec._refresh.append((u, s, e))
                    heappush(rq, (due + rint, u, toks))
            p = exec_plan[i]
            lp = len(p)
            if lp == 2:
                rid, du = p
                t0 = free[rid]
                start = dep_t if dep_t > t0 else t0
                end = start + du
                free[rid] = end
                op_busy += du
                if observe:
                    probes += 1
                    if rec_tasks is not None:
                        rec_tasks.append((i, start, end))
            elif lp == 3:
                # single-segment intra-bank move (common case, pre-flattened)
                rids, stall_counts, du = p
                s = dep_t
                for r in rids:
                    f = free[r]
                    if f > s:
                        s = f
                end = s + du
                for r in rids:
                    free[r] = end
                if stall_counts:
                    span = end - s
                    for cnt in stall_counts:
                        stall += cnt * span
                move_busy += du
                if observe:
                    probes += len(rids)
                    if rec_tasks is not None:
                        rec_tasks.append((i, s, end))
            else:
                end = dep_t
                for _sk, seg in enumerate(p[0]):
                    if seg[0] == CIRCUIT:
                        _, rids, stall_counts, du, busy_keys, ej = seg
                        s = dep_t
                        for r in rids:
                            f = free[r]
                            if f > s:
                                s = f
                        e = s + du
                        for r in rids:
                            free[r] = e
                        if stall_counts:
                            span = e - s
                            for cnt in stall_counts:
                                stall += cnt * span
                        if busy_keys:
                            span = e - s
                            for k in busy_keys:
                                bus_busy[k] += span
                        move_busy += du
                        if observe:
                            probes += len(rids)
                            if rec_segs is not None:
                                rec_segs.append((i, _sk, -1, s, e))
                    else:
                        (_, leg1, leg2, leg3, drain, transit, fill, drain1,
                         transit1, fill1, mb, busy_keys, ej) = seg
                        s1 = dep_t
                        for r in leg1:
                            f = free[r]
                            if f > s1:
                                s1 = f
                        e1 = s1 + drain
                        for r in leg1:
                            free[r] = e1
                        s2 = s1 + drain1
                        for r in leg2:
                            f = free[r]
                            if f > s2:
                                s2 = f
                        e2 = s2 + transit
                        for r in leg2:
                            free[r] = e2
                        for k in busy_keys:
                            bus_busy[k] += transit
                        s3 = s2 + transit1
                        for r in leg3:
                            f = free[r]
                            if f > s3:
                                s3 = f
                        e = s3 + fill
                        alt = e2 + fill1
                        if alt > e:
                            e = alt
                        for r in leg3:
                            free[r] = e
                        move_busy += mb
                        if observe:
                            probes += len(leg1) + len(leg2) + len(leg3)
                            if rec_segs is not None:
                                rec_segs.append((i, _sk, 0, s1, e1))
                                rec_segs.append((i, _sk, 1, s2, e2))
                                rec_segs.append((i, _sk, 2, s3, e))
                    if ej:
                        energy += ej
                    if e > end:
                        end = e

            finish[i] = end
            for s_ in succ[i]:
                if ready_t[s_] < end:
                    ready_t[s_] = end
                nd = indeg[s_] - 1
                indeg[s_] = nd
                if not nd:
                    heappush(heap, (neg_cp[s_], end, guids[s_], s_))
            j = job_of[i]
            if job_fin[j] < end:
                job_fin[j] = end
            rem = job_rem[j] - 1
            job_rem[j] = rem
            if not rem:
                completed.append(j)
                if rec is not None:
                    rec._jobdone.append((j, job_fin[j]))
            n_exec += 1

        self._n_live -= n_exec
        if not heap and self._n_live:
            raise RuntimeError("engine deadlock: not all tasks executed "
                               "(graph validation should have caught this)")
        self._op_busy = op_busy
        self._move_busy = move_busy
        self._stall = stall
        self._energy = energy
        self._refresh_ns = refresh_ns
        self._n_refresh = n_refresh
        if prof is not None:
            # pops == executed tasks (horizon/completion breaks only peek);
            # pushes fall out of the heap-size delta, so the hot loop
            # carries no push counter
            prof.record_advance(
                wall_s=time.perf_counter() - _wall0, n_exec=n_exec,
                heap_pushes=len(heap) - _heap0 + n_exec,
                token_probes=probes,
                refresh_windows=n_refresh - _refresh0)
        if until is None:
            mx = max(finish) if finish else 0.0
            if mx > self.now:
                self.now = mx
        elif until > self.now:
            self.now = until
        return completed

    # --- results ----------------------------------------------------------------

    def makespan(self) -> float:
        """Latest finish time executed so far (cheap :meth:`stats` subset).

        The placement-search oracle calls the engine thousands of times and
        only ever reads this one float; building the full
        :class:`EngineStats` (finish-time dict included) per call would
        dominate the oracle's budget.  Identical to
        ``stats().makespan_ns`` under both event loops.
        """
        finish = self._h_finish if self._vec is not None else self._finish
        return max(finish) if finish else 0.0

    def stats(self) -> EngineStats:
        """Aggregate schedule outcome over everything executed so far."""
        finish = self._h_finish if self._vec is not None else self._finish
        return EngineStats(
            makespan_ns=max(finish) if finish else 0.0,
            op_busy_ns=self._op_busy, move_busy_ns=self._move_busy,
            stall_ns=self._stall, n_ops=self._n_ops, n_moves=self._n_moves,
            n_rows_moved=self._n_rows, n_cross_moves=self._n_cross,
            energy_j=self._energy, rows_by_route=self._rows_by_route,
            bus_busy_ns=self._bus_busy,
            finish_times=dict(zip(self._guids, finish)),
            refresh_ns=self._refresh_ns,
            n_refresh_windows=self._n_refresh,
            op_energy_j=self._op_energy,
            move_energy_j=self._move_energy,
            # one multiplication, not a loop accumulation: identical under
            # the vectorized engine's refresh idle-gap collapse, which
            # batches whole windows without touching per-window floats
            refresh_energy_j=self._n_refresh
            * self.model.energy_table().refresh_window_j)


def run(g: TaskGraph, model: ResourceModel, *,
        validate: bool = True, engine: str = "vector",
        device: str | torch.device = "cuda") -> EngineStats:
    """List-schedule ``g`` on ``model``'s resource tokens (one-shot).

    A thin wrapper over :class:`EngineSession` — one graph admitted at
    t=0, no refresh, advanced to completion — bit-for-bit identical to the
    pre-session event loop (golden schedules assert this).  ``engine``
    selects the vectorized hot path (default) or the scalar oracle;
    ``device`` is ``cuda`` unless the caller asks for the CPU.
    """
    session = EngineSession(model, validate=validate, engine=engine,
                            device=device)
    session.admit(g, at=0.0, uid_offset=0)
    session.advance()
    return session.stats()


def oracle_makespan(g: TaskGraph, model: ResourceModel, *,
                    engine: str = "vector",
                    validate: bool = False,
                    device: str | torch.device = "cuda") -> float:
    """Makespan-only engine evaluation — the placement search's cost oracle.

    Exactly :func:`run` minus the :class:`EngineStats` construction: one
    graph admitted at t=0, advanced to completion, one float returned.
    The schedule computed is bit-identical to :func:`run`'s (same session,
    same event loop), so a searched placement's reported makespan is always
    an ordinary engine result — the search's surrogate never produces this
    number.  ``validate`` defaults off because the oracle evaluates remaps
    of one already-validated graph.
    """
    session = EngineSession(model, validate=validate, engine=engine,
                            device=device)
    session.admit(g, at=0.0, uid_offset=0)
    session.advance()
    return session.makespan()
