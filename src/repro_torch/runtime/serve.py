"""Online serving runtime: job streams through one incremental engine session
(PyTorch port of ``repro/runtime/serve.py``).

:class:`ServingRuntime` is the layer the ROADMAP's "serve heavy traffic"
goal asks for: a trace of :class:`~repro_torch.runtime.trace.JobRequest` arrivals
is admitted against a :class:`~repro_torch.runtime.allocator.BankAllocator`
(bank-set leases, FIFO / SJF / priority admission), each admitted job's
*logical* graph runs through the :mod:`repro_torch.passes` lease pipeline —
``validate -> lease-place -> optimize -> legalize``, where the place stage
is the ordinary partitioner placement
(:func:`repro_torch.device.partition.place_on_banks`) and the optimize stage is
whatever passes the runtime was configured with (none by default: the
pipeline-off path is bit-for-bit the pre-pipeline one) — and is spliced
into a live :class:`~repro_torch.core.engine.EngineSession`, so tenants contend
for bank tokens, shared buses, and (with a
:class:`~repro_torch.core.engine.RefreshSpec`) refresh windows through exactly
the machinery the offline scheduler uses.
The runtime advances the session between arrival horizons, releases leases
as jobs complete, and reports per-job latency.

Determinism: the same (trace, geometry, interconnect, admission policy,
refresh) always produces the same per-job completion times — there is no
wall clock anywhere in the stack.

The one live session runs on the runtime's ``device`` (``cuda`` unless the
caller asks for the CPU; there is no fallback), and so does the placement
search when ``placement="search"``.  Graphs, leases and every result stay
host data, and a run on the card equals one on the host bit for bit.
Latency summaries are NumPy percentiles of host floats, as in the
reference, so they match it to the last bit.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from repro_torch import passes as passlib
from repro_torch.core import ir, taskgraph
from repro_torch.core.engine import EngineSession, RefreshSpec
from repro_torch.core.ir import TaskGraph
from repro_torch.core.pluto import Interconnect
from repro_torch.device import resolve
from repro_torch.device.geometry import DeviceGeometry
from repro_torch.device.resources import DeviceModel
from repro_torch.runtime.allocator import (BankAllocator, ContinuousAllocator,
                                     Lease)
from repro_torch.runtime.trace import (ClosedLoopSource, JobRequest,
                                 MultiTurnSource, SessionRequest)


@dataclasses.dataclass(frozen=True)
class JobResult:
    """One served job: who, when, and how long it waited."""

    tenant: str
    app: str
    seq: int
    arrival_ns: float
    admit_ns: float              # lease granted / graph spliced
    finish_ns: float
    banks: tuple[int, ...]
    n_tasks: int
    #: direct metered energy of this job's own tasks, in nanojoules
    #: (compute + moves; refresh apportionment is a recorder-level view —
    #: see :func:`repro_torch.obs.metrics.energy_attribution`)
    energy_nj: float = 0.0

    @property
    def latency_ns(self) -> float:
        return self.finish_ns - self.arrival_ns

    @property
    def queue_ns(self) -> float:
        return self.admit_ns - self.arrival_ns

    @property
    def service_ns(self) -> float:
        return self.finish_ns - self.admit_ns


class ServingRuntime:
    """Streaming multi-tenant serving over one device (see module docstring).

    One runtime = one device under one interconnect, one admission policy,
    and optionally one refresh spec.  ``run`` consumes an open-loop trace
    (a list of requests), a :class:`ClosedLoopSource`, or both.
    """

    def __init__(self, mode: Interconnect, geom: DeviceGeometry, *,
                 admission: str = "fifo",
                 placement: str = "locality_first",
                 opt: tuple[str, ...] = (),
                 search=None,
                 refresh: RefreshSpec | None = None,
                 model: DeviceModel | None = None,
                 recorder=None, metrics=None,
                 device: str | torch.device = "cuda"):
        self.device = resolve(device)
        if model is None:
            model = DeviceModel(mode, geom)
        self.mode = mode
        self.geom = geom
        self.placement = placement
        # opt-in cost-driven lease placement: ``placement="search"`` runs
        # each leased job's graph through the search place stage
        # (repro_torch.search: engine-oracle beam + annealing over the
        # leased banks) instead of one greedy policy; ``search`` optionally
        # carries a repro_torch.search.SearchConfig, whose oracle runs on
        # this runtime's device.  Graphs stay memoized per (app, kw,
        # banks), so the search cost is paid once per distinct lease shape,
        # not per admission.
        if placement == "search":
            from repro_torch.search import SearchConfig
            search = dataclasses.replace(search or SearchConfig(),
                                         device=str(self.device))
        self.search = search
        self.opt = tuple(opt)
        # opt-in observability (repro_torch.obs): the recorder is forwarded into
        # the engine session (schedule tracing) and additionally captures
        # the serving events the engine cannot see — arrivals, lease
        # grant/release, queue depth; the metrics registry accumulates
        # queue-depth / lease-occupancy series and latency histograms.
        # With neither attached the serving path is unchanged.
        self.recorder = recorder
        self.metrics = metrics
        self.session = EngineSession(model, refresh=refresh,
                                     recorder=recorder, device=self.device)
        self.allocator = BankAllocator(geom, admission)
        self.results: list[JobResult] = []
        self.rewrite_logs: dict = {}  # (app, kw, banks) -> RewriteLog
        self._graphs: dict = {}      # (app, kw, banks) -> materialized graph
        self._costs: dict = {}       # (app, kw, banks) -> job_cost estimate
        self._live: dict = {}        # engine job id -> (request, lease, at)
        #: engine job id -> tenant name, for every job ever admitted —
        #: the mapping :func:`repro_torch.obs.metrics.energy_attribution` takes
        #: to roll per-job joules up to tenants
        self.job_tenants: dict = {}

    # --- job graphs -------------------------------------------------------------

    def _lease_pipeline(self, banks: tuple[int, ...]):
        """The lease pipeline for one bank set under this runtime's config."""
        if self.placement == "search":
            return passlib.lease_search_pipeline(
                self.geom, banks, self.mode, config=self.search,
                opt=self.opt)
        return passlib.lease_pipeline(self.geom, banks, self.placement,
                                      opt=self.opt)

    def _graph(self, req: JobRequest, banks: tuple[int, ...]) -> TaskGraph:
        t = req.tenant
        key = (t.app, t.kw, banks)
        g = self._graphs.get(key)
        if g is None:
            struct = taskgraph.structural(
                t.app, n_pes=len(banks) * self.geom.pes_per_bank, **t.kwargs)
            placed, log = self._lease_pipeline(banks).run(struct)
            self.rewrite_logs[key] = log
            g = self._graphs[key] = ir.materialize(placed, self.mode)
        return g

    def job_cost(self, req: JobRequest) -> float:
        """SJF cost estimate: the job graph's task count (size proxy that
        needs no placement, so queued jobs are priced before any lease).

        Memoized per ``(app, kw, banks)`` — identical tenant specs share
        one structural build instead of re-deriving the graph on every
        arrival of the hot admission path.
        """
        t = req.tenant
        key = (t.app, t.kw, t.banks)
        cost = self._costs.get(key)
        if cost is None:
            cost = self._costs[key] = float(taskgraph.structural(
                t.app, n_pes=t.banks * self.geom.pes_per_bank, **t.kwargs).n)
        return cost

    # --- the serving loop -------------------------------------------------------

    def run(self, requests=(), *, closed: ClosedLoopSource | None = None
            ) -> list[JobResult]:
        """Serve every request to completion; returns per-job results.

        ``requests`` come from :func:`~repro_torch.runtime.trace.open_loop_trace`
        (or any JobRequest iterable); ``closed`` adds a closed-loop source
        whose follow-up arrivals are generated as completions land.
        """
        pending: list[tuple] = []
        for r in requests:
            heapq.heappush(pending, (*r.sort_key, r))
        if closed is not None:
            for r in closed.initial():
                heapq.heappush(pending, (*r.sort_key, r))
        for _, _, _, r in pending:
            if r.tenant.banks > self.geom.n_banks:
                raise ValueError(
                    f"tenant {r.tenant.name!r} wants {r.tenant.banks} banks; "
                    f"device has {self.geom.n_banks}")

        first = len(self.results)
        while True:
            until = pending[0][0] if pending else None
            # with jobs queued for banks, stop at the first completion so
            # the freed lease re-admits before more schedule is committed
            done = self.session.advance(
                until, stop_on_completion=self.allocator.n_queued > 0)
            if done:
                # replay completions in finish order, admitting arrivals
                # that land before each release so queue order is causal
                done.sort(key=lambda jid: (self.session.job(jid).finish_ns,
                                           jid))
                for jid in done:
                    req, lease, _at = self._live.pop(jid)
                    rec = self.session.job(jid)
                    while pending and pending[0][0] <= rec.finish_ns:
                        self._submit(heapq.heappop(pending)[3])
                    result = JobResult(
                        req.tenant.name, req.tenant.app, req.seq,
                        req.arrival_ns, rec.admit_ns, rec.finish_ns,
                        lease.banks, rec.n_tasks,
                        energy_nj=rec.energy_j * 1e9)
                    self.results.append(result)
                    if closed is not None:
                        nxt = closed.on_complete(req, rec.finish_ns)
                        if nxt is not None:
                            heapq.heappush(pending, (*nxt.sort_key, nxt))
                    if self.recorder is not None:
                        self.recorder.lease_release(lease.ticket,
                                                    rec.finish_ns)
                    for granted in self.allocator.release(lease):
                        self._start(granted, now=rec.finish_ns)
                    if self.metrics is not None:
                        self._observe_completion(result, rec.finish_ns)
                continue
            if until is None:
                if self.allocator.n_queued:
                    raise RuntimeError(
                        "device drained with jobs still queued — allocator "
                        "and session disagree about capacity")
                break
            # no completion before the horizon: admit everything arriving
            # at it, then re-advance
            while pending and pending[0][0] <= until:
                self._submit(heapq.heappop(pending)[3])
        return self.results[first:]

    def _submit(self, req: JobRequest) -> None:
        if self.recorder is not None:
            self.recorder.arrival(req.arrival_ns, req.tenant.name, req.seq)
        for granted in self.allocator.request(
                req.tenant.banks, priority=req.tenant.priority,
                cost=self.job_cost(req), payload=req):
            self._start(granted, now=req.arrival_ns)
        if self.metrics is not None:
            self.metrics.counter("jobs_arrived").inc()
            self._observe_occupancy(req.arrival_ns)

    def _start(self, lease: Lease, now: float) -> None:
        req: JobRequest = lease.payload
        at = now if now > req.arrival_ns else req.arrival_ns
        g = self._graph(req, lease.banks)
        jid = self.session.admit(g, at=at)
        self._live[jid] = (req, lease, at)
        self.job_tenants[jid] = req.tenant.name
        if self.recorder is not None:
            self.recorder.lease_grant(lease.ticket, lease.banks, at,
                                      req.tenant.name)

    # --- observability ----------------------------------------------------------

    def _observe_occupancy(self, t_ns: float) -> None:
        """Queue-depth and lease-occupancy series points at ``t_ns``."""
        m = self.metrics
        m.gauge("queue_depth").record(t_ns, self.allocator.n_queued)
        m.gauge("lease_occupancy").record(t_ns, self.allocator.occupancy)

    def _observe_completion(self, result: JobResult, t_ns: float) -> None:
        m = self.metrics
        m.counter("jobs_completed").inc()
        m.histogram("latency_ns").observe(result.latency_ns)
        m.histogram("queue_ns").observe(result.queue_ns)
        m.histogram(f"latency_ns/{result.tenant}").observe(result.latency_ns)
        m.counter("energy_nj").inc(result.energy_nj)
        m.counter(f"energy_nj/{result.tenant}").inc(result.energy_nj)
        self._observe_occupancy(t_ns)

    def export_trace(self, path, metadata: dict | None = None):
        """Dump the recorded schedule as Chrome trace JSON (returns path).

        The metadata block carries the runtime's full provenance — mode,
        geometry, admission/placement/opt configuration, and every job
        graph's rewrite log — so the trace is reproducible, not just a
        picture.  Requires the runtime to have been built with a recorder.
        """
        if self.recorder is None:
            raise ValueError(
                "ServingRuntime has no recorder; construct it with "
                "ServingRuntime(..., recorder=obs.Recorder())")
        from repro_torch.obs.trace import rewrite_log_metadata
        meta = {
            "geometry": self.geom.describe(),
            "admission": self.allocator.policy,
            "placement": self.placement,
            "opt": list(self.opt),
        }
        meta.update(rewrite_log_metadata(self.rewrite_logs))
        if metadata:
            meta.update(metadata)
        return self.recorder.dump(path, meta)


# --- continuous batching: sessions served one iteration at a time ---------------


@dataclasses.dataclass(frozen=True)
class SessionResult:
    """One served conversation: every token's landing time plus the
    residency lifecycle counters (migrations, preemptions, final footprint).
    """

    tenant: str
    app: str
    seq: int
    arrival_ns: float
    admit_ns: float              # first prefill lease grant (queue exit)
    finish_ns: float             # last token of the last turn
    token_ns: tuple              # decode-token finish times, all turns
    turn_start_ns: tuple         # per-turn arrival / think-wake times
    turn_first_ns: tuple         # per-turn first-token finish times
    tokens_per_turn: int
    banks_resident: int          # residency footprint at session end
    n_migrations: int
    n_preemptions: int
    n_tasks: int
    energy_nj: float = 0.0

    @property
    def latency_ns(self) -> float:
        return self.finish_ns - self.arrival_ns

    @property
    def queue_ns(self) -> float:
        return self.admit_ns - self.arrival_ns

    @property
    def service_ns(self) -> float:
        return self.finish_ns - self.admit_ns

    @property
    def ttft_ns(self) -> float:
        """Arrival to the very first generated token (includes queueing)."""
        return self.turn_first_ns[0] - self.arrival_ns

    @property
    def ttft_samples(self) -> tuple:
        """Per-turn first-token latencies (turn start -> first token)."""
        return tuple(f - s for s, f in zip(self.turn_start_ns,
                                           self.turn_first_ns))

    @property
    def tpot_samples(self) -> tuple:
        """Successive-token gaps within each turn (never across think
        time — a user pause is not a slow token)."""
        d = self.tokens_per_turn
        out = []
        for i in range(0, len(self.token_ns), d):
            turn = self.token_ns[i:i + d]
            out.extend(b - a for a, b in zip(turn, turn[1:]))
        return tuple(out)


class _Session:
    """Mutable in-flight record of one conversation (runtime-internal)."""

    def __init__(self, req: SessionRequest):
        self.req = req
        self.spec = req.session
        self.turn = 0
        self.prompt_left = 0         # prompt tokens this turn still to prefill
        self.chunk_toks = 0          # tokens the in-flight chunk covers
        self.tokens_left = 0         # decode tokens this turn still to emit
        self.kv_seen = 0             # KV tokens accumulated pre-residency
        self.lease = None            # turn-1 prefill lease (pool)
        self.res = None              # Residency once adopted
        self.admit_ns = None
        self.token_ns: list = []
        self.turn_start: list = []
        self.turn_first: list = []
        self.last_token_ns = None    # None while thinking / pre-first-token
        self.ready = False           # wants a step at the next iteration
        self.migrating = False
        self.chunk_deferred = False  # residency prefill yielded to decode
        self.n_migrations = 0
        self.n_preemptions = 0
        self.n_tasks = 0
        self.energy_nj = 0.0


class ContinuousRuntime(ServingRuntime):
    """Iteration-level continuous batching over one live engine session.

    The whole-job lifecycle (:meth:`ServingRuntime.run`) is inherited
    untouched — constructed with ``continuous=False`` this class *is* the
    classic runtime, bit for bit.  With continuous batching on, the
    allocator becomes a :class:`ContinuousAllocator` and
    :meth:`run_sessions` serves conversations instead of closed jobs:

    * **prefill** is chunked (``chunk_tokens`` per spliced job) into the
      pool-capped prefill queue; at every chunk boundary the scheduler may
      preempt — the allocator takes the banks back, the session requeues
      ahead of everything, and on re-admission the spilled KV is streamed
      back in through a real move graph (preemption is priced, not free);
    * **the residency** is adopted in place when prefill completes: the KV
      is already in the lease's banks, so no data moves.  It then grows
      per decoded token and per later-turn prompt; when growth finds no
      free neighbor bank, the runtime migrates the KV to a fresh
      defragmented placement priced via the interconnect's move cost
      model (both placements held until the copy lands);
    * **decode** runs as synchronized iterations: when every step of the
      current iteration has completed, all runnable sessions splice their
      next one-token graph (:func:`repro_torch.frontend.lower.decode_step`
      shape) at the same instant, so a session is a chain of small jobs
      flowing around its peers' prefill — the paper's concurrent
      computation-and-data-flow regime at serving granularity;
    * **the TPOT deadline** (``tpot_slo_ns``) drives preemption: when an
      active decode session's next token would land past its per-token
      deadline if another prefill chunk ran first (estimated from an EMA
      of observed chunk service times), prefill admission pauses and
      running prefill is preempted at its next chunk boundary, resuming
      once the pressure clears.

    Everything is deterministic: no wall clock, no RNG — the same
    (sessions, geometry, interconnect, SLO) replays identically.
    """

    def __init__(self, mode: Interconnect, geom: DeviceGeometry, *,
                 admission: str = "fifo", continuous: bool = True,
                 chunk_tokens: int = 256, tokens_per_bank: int = 512,
                 tpot_slo_ns: float | None = None,
                 decode_reserve: int | None = None, **kw):
        super().__init__(mode, geom, admission=admission, **kw)
        if chunk_tokens < 1:
            raise ValueError(f"chunk_tokens must be >= 1, got {chunk_tokens}")
        self.continuous = continuous
        self.chunk_tokens = chunk_tokens
        self.tpot_slo_ns = tpot_slo_ns
        self.session_results: list[SessionResult] = []
        if continuous:
            self.allocator = ContinuousAllocator(
                geom, admission, decode_reserve=decode_reserve,
                tokens_per_bank=tokens_per_bank)
            from repro_torch.frontend.lower import kv_tiles_for
            self._kv_tiles = kv_tiles_for
        self._states: list[_Session] = []
        self._inflight: set[int] = set()  # this iteration's decode-step jids
        self._jobs: dict = {}             # jid -> (kind, _Session, at)
        self._chunk_ema = None            # EMA of chunk service times
        self._source: MultiTurnSource | None = None
        self._now = 0.0
        self._evsq = 0

    # --- the iteration scheduler ------------------------------------------------

    def run_sessions(self, sessions=(), *,
                     source: MultiTurnSource | None = None
                     ) -> list[SessionResult]:
        """Serve every session to its last token; per-session results.

        ``sessions`` come from :func:`~repro_torch.runtime.trace.session_trace`;
        ``source`` adds a closed-loop :class:`MultiTurnSource` whose next
        conversations arrive as sessions complete.
        """
        if not self.continuous:
            raise ValueError(
                "run_sessions needs continuous batching; this runtime was "
                "built with continuous=False (whole-job mode) — use run()")
        pending: list = []
        for r in sessions:
            self._push(pending, r.arrival_ns, "session", r)
        if source is not None:
            for r in source.initial():
                self._push(pending, r.arrival_ns, "session", r)
        self._source = source
        first = len(self.session_results)
        while True:
            until = pending[0][0] if pending else None
            done = self.session.advance(until, stop_on_completion=True)
            if done:
                done.sort(key=lambda j: (self.session.job(j).finish_ns, j))
                for jid in done:
                    rec = self.session.job(jid)
                    now = self._now = max(self._now, rec.finish_ns)
                    while pending and pending[0][0] <= now:
                        self._event(pending, heapq.heappop(pending))
                    kind, s, at = self._jobs.pop(jid)
                    self._inflight.discard(jid)
                    s.energy_nj += rec.energy_j * 1e9
                    s.n_tasks += rec.n_tasks
                    if kind == "chunk":
                        self._chunk_done(pending, s, at, rec.finish_ns)
                    elif kind == "step":
                        self._step_done(pending, s, rec.finish_ns)
                    elif kind == "install":
                        self._splice_chunk(s, rec.finish_ns)
                    else:
                        self._migrate_done(s, rec.finish_ns)
                    self._rebalance(rec.finish_ns)
                    self._maybe_iterate(rec.finish_ns)
                continue
            if until is None:
                if self._jobs:
                    raise RuntimeError(
                        "engine drained with session jobs still live")
                if self.allocator.n_queued:
                    # nothing left in flight can clear the deadline gate —
                    # lift it so the queued prefill re-admits
                    self.allocator.admission_paused = False
                    granted = self.allocator.drain()
                    if not granted:
                        raise RuntimeError(
                            "device drained with prefill still queued — "
                            "allocator and session disagree about capacity")
                    for lease in granted:
                        self._admit_prefill(lease, self._now)
                    continue
                break
            self._now = max(self._now, until)
            while pending and pending[0][0] <= until:
                self._event(pending, heapq.heappop(pending))
            self._rebalance(until)
            self._maybe_iterate(until)
        return self.session_results[first:]

    # --- event handling ---------------------------------------------------------

    def _push(self, pending: list, t: float, kind: str, obj) -> None:
        heapq.heappush(pending, (t, self._evsq, kind, obj))
        self._evsq += 1

    def _event(self, pending: list, item) -> None:
        t, _, kind, obj = item
        self._now = max(self._now, t)
        if kind == "session":
            s = _Session(obj)
            self._states.append(s)
            s.turn_start.append(t)
            s.prompt_left = s.spec.prompt_tokens
            if self.recorder is not None:
                self.recorder.arrival(t, s.spec.name, obj.seq)
            banks = max(1, min(self.allocator.prefill_pool,
                               self.allocator.banks_for(
                                   s.spec.prompt_tokens)))
            for lease in self.allocator.request(
                    banks, priority=s.spec.priority,
                    cost=float(s.spec.prompt_tokens), payload=s):
                self._admit_prefill(lease, t)
        else:  # "turn": think time over, the next prompt arrives
            s = obj
            s.turn_start.append(t)
            s.prompt_left = s.spec.prompt_tokens
            if s.migrating:
                pass                     # chunks resume when the copy lands
            elif self._pressure(t):
                s.chunk_deferred = True
                s.n_preemptions += 1
            else:
                self._splice_chunk(s, t)

    def _admit_prefill(self, lease: Lease, now: float) -> None:
        s: _Session = lease.payload
        s.lease = lease
        if s.admit_ns is None:
            s.admit_ns = now
        if self.recorder is not None:
            self.recorder.lease_grant(lease.ticket, lease.banks, now,
                                      s.spec.name)
        if s.kv_seen > 0:
            # re-admitted after a preemption evicted the partial KV: stream
            # it back into the (possibly different) banks before computing
            g = self._kv_install_graph(lease.banks, s.kv_seen)
            if g.n:
                jid = self.session.admit(g, at=now)
                self._jobs[jid] = ("install", s, now)
                self.job_tenants[jid] = s.spec.name
                return
        self._splice_chunk(s, now)

    def _splice_chunk(self, s: _Session, now: float) -> None:
        toks = min(self.chunk_tokens, s.prompt_left)
        kv = s.res.kv_tokens if s.res is not None else s.kv_seen
        banks = s.res.banks if s.res is not None else s.lease.banks
        g = self._session_graph(s.spec, "prefill", self._kv_tiles(kv),
                                self._chunk_tiles(toks), banks)
        jid = self.session.admit(g, at=now)
        self._jobs[jid] = ("chunk", s, now)
        self.job_tenants[jid] = s.spec.name
        s.chunk_toks = toks

    def _chunk_done(self, pending: list, s: _Session, at: float,
                    now: float) -> None:
        service = now - at
        self._chunk_ema = service if self._chunk_ema is None \
            else 0.5 * self._chunk_ema + 0.5 * service
        s.prompt_left -= s.chunk_toks
        if s.res is not None:
            self.allocator.grow(s.res, s.chunk_toks)
            self._try_migrate(s, now)
        else:
            s.kv_seen += s.chunk_toks
        if s.migrating:
            # chunks resume when the copy lands; if this was the last
            # chunk, arm decode so _migrate_done marks the session ready
            if s.prompt_left <= 0:
                s.tokens_left = s.spec.decode_tokens
            return
        if s.prompt_left > 0:
            if self._pressure(now):
                s.n_preemptions += 1
                if s.lease is not None:
                    # full preemption: the pool takes the banks back, the
                    # session requeues ahead of every queued prefill
                    if self.recorder is not None:
                        self.recorder.lease_release(s.lease.ticket, now)
                    self.allocator.preempt(s.lease)
                    s.lease = None
                    self.allocator.admission_paused = True
                else:
                    s.chunk_deferred = True   # residency held, compute yields
            else:
                self._splice_chunk(s, now)
            return
        # prefill complete: turn the lease into the session's residency
        if s.lease is not None:
            if self.recorder is not None:
                self.recorder.lease_release(s.lease.ticket, now)
            s.res = self.allocator.adopt(s.lease, s.spec.name, s.kv_seen)
            s.lease = None
            for lease in self.allocator.drain():
                self._admit_prefill(lease, now)
        s.tokens_left = s.spec.decode_tokens
        s.ready = True

    def _step_done(self, pending: list, s: _Session, now: float) -> None:
        s.token_ns.append(now)
        if len(s.turn_first) < len(s.turn_start):
            s.turn_first.append(now)
        if self.metrics is not None:
            self.metrics.counter("tokens_decoded").inc()
            if s.last_token_ns is not None:
                self.metrics.histogram("tpot_ns").observe(
                    now - s.last_token_ns)
        s.last_token_ns = now
        s.tokens_left -= 1
        more = s.tokens_left > 0 or s.turn + 1 < s.spec.turns
        self.allocator.grow(s.res, 1)
        if more:
            self._try_migrate(s, now)
        if s.tokens_left > 0:
            if not s.migrating:
                s.ready = True
            return
        s.turn += 1
        if s.turn < s.spec.turns:
            s.last_token_ns = None       # thinking: no token deadline runs
            self._push(pending, now + s.spec.think_ns, "turn", s)
            return
        self._finish_session(pending, s, now)

    def _frag(self, banks: tuple[int, ...]) -> tuple[int, int]:
        """Fragmentation score of a bank set: (groups spanned, 0 if the
        set is one contiguous run else 1).  Lower is cheaper for the
        residency's internal KV traffic."""
        groups = len({self.geom.group_of_bank(b) for b in banks})
        contig = max(banks) - min(banks) + 1 == len(banks)
        return (groups, 0 if contig else 1)

    def _try_migrate(self, s: _Session, now: float) -> None:
        """Defragment the residency if churn scattered its growth: when a
        strictly better placement is free, copy the KV there (a real move
        job, priced by the interconnect) and retire the old banks."""
        cur = self._frag(s.res.banks)
        if cur == (1, 0):
            return                       # already a single-group run
        dst = self.allocator.begin_migration(s.res)
        if dst is None:
            return                       # no second copy fits; retry later
        if self._frag(dst) >= cur:
            self.allocator.abort_migration(s.res)
            return
        g = self._kv_move_graph(s.res.banks, dst, s.res.kv_tokens)
        if g.n == 0:
            self.allocator.commit_migration(s.res)
            s.n_migrations += 1
            return
        jid = self.session.admit(g, at=now)
        self._jobs[jid] = ("migrate", s, now)
        self.job_tenants[jid] = s.spec.name
        s.migrating = True

    def _migrate_done(self, s: _Session, now: float) -> None:
        self.allocator.commit_migration(s.res)
        s.migrating = False
        s.n_migrations += 1
        if s.prompt_left > 0:
            if self._pressure(now):
                s.chunk_deferred = True
            else:
                self._splice_chunk(s, now)
        elif s.tokens_left > 0:
            s.ready = True

    def _finish_session(self, pending: list, s: _Session,
                        now: float) -> None:
        result = SessionResult(
            s.spec.name, s.spec.app, s.req.seq, s.req.arrival_ns,
            s.admit_ns, now, tuple(s.token_ns), tuple(s.turn_start),
            tuple(s.turn_first), s.spec.decode_tokens, len(s.res.banks),
            s.n_migrations, s.n_preemptions, s.n_tasks, s.energy_nj)
        self.session_results.append(result)
        self._states.remove(s)
        for lease in self.allocator.release_residency(s.res):
            self._admit_prefill(lease, now)
        s.res = None
        if self.metrics is not None:
            self.metrics.counter("sessions_completed").inc()
            self.metrics.histogram("session_latency_ns").observe(
                result.latency_ns)
        if self._source is not None:
            nxt = self._source.on_session_complete(s.req, now)
            if nxt is not None:
                self._push(pending, nxt.arrival_ns, "session", nxt)

    # --- deadline pressure ------------------------------------------------------

    def _pressure(self, now: float) -> bool:
        """Would one more prefill chunk push an active decode stream past
        its per-token deadline?  (Estimated via the chunk-service EMA; no
        estimate yet — first chunk ever — means no pressure.)"""
        if self.tpot_slo_ns is None or self._chunk_ema is None:
            return False
        for d in self._states:
            if d.res is None or d.last_token_ns is None or d.tokens_left <= 0:
                continue
            if now + self._chunk_ema > d.last_token_ns + self.tpot_slo_ns:
                return True
        return False

    def _rebalance(self, now: float) -> None:
        """Open or close the admission gate to match current pressure."""
        if self._pressure(now):
            self.allocator.admission_paused = True
            return
        self.allocator.admission_paused = False
        for lease in self.allocator.drain():
            self._admit_prefill(lease, now)
        for s in self._states:
            if s.chunk_deferred and not s.migrating:
                s.chunk_deferred = False
                self._splice_chunk(s, now)

    def _maybe_iterate(self, now: float) -> None:
        """Launch the next decode iteration once the current one drains:
        every runnable session's one-token graph splices at the same
        instant — the continuous batch."""
        if self._inflight:
            return
        ready = [s for s in self._states if s.ready]
        if not ready:
            return
        ready.sort(key=lambda s: (s.spec.name, s.req.seq))
        for s in ready:
            s.ready = False
            grant = self.allocator.grant_step(s.res)
            g = self._session_graph(
                s.spec, "decode", self._kv_tiles(s.res.kv_tokens), None,
                grant.banks)
            jid = self.session.admit(g, at=now)
            self._jobs[jid] = ("step", s, now)
            self._inflight.add(jid)
            self.job_tenants[jid] = s.spec.name

    # --- session job graphs -----------------------------------------------------

    def _session_graph(self, spec, phase: str, kv_tiles: int,
                       seq_tiles: int | None,
                       banks: tuple[int, ...]) -> TaskGraph:
        key = (spec.app, spec.kw, phase, kv_tiles, seq_tiles, banks)
        g = self._graphs.get(key)
        if g is None:
            struct = taskgraph.structural(
                spec.app, phase=phase,
                n_pes=len(banks) * self.geom.pes_per_bank,
                kv_tiles=kv_tiles, seq_tiles=seq_tiles, **spec.kwargs)
            placed, log = self._lease_pipeline(banks).run(struct)
            self.rewrite_logs[key] = log
            g = self._graphs[key] = ir.materialize(placed, self.mode)
        return g

    def _chunk_tiles(self, toks: int) -> int:
        """Sequence tiles for one prefill chunk (128 tokens per tile,
        capped at the whole-prefill default width)."""
        return max(1, min(4, -(-toks // 128)))

    def _kv_rows(self, banks: int, kv_tokens: int) -> int:
        """DRAM rows of KV per bank move (64 tokens per row, capped)."""
        per = -(-kv_tokens // max(1, banks))
        return max(1, min(128, -(-per // 64)))

    def _kv_move_graph(self, src_banks: tuple[int, ...],
                       dst_banks: tuple[int, ...],
                       kv_tokens: int) -> TaskGraph:
        """Residency migration: per-bank KV copies old home -> new home,
        priced by the session's interconnect (LISA pays distance,
        Shared-PIM store-and-forwards) — migration is never free."""
        b = ir.GraphBuilder()
        rows = self._kv_rows(len(src_banks), kv_tokens)
        for i, dst in enumerate(dst_banks):
            src = src_banks[i % len(src_banks)]
            if src == dst:
                continue
            b.move(self.geom.pe(src, 0), self.geom.pe(dst, 0), rows=rows,
                   tag=f"kvmig b{src}->b{dst}")
        return ir.materialize(b.build(), self.mode)

    def _kv_install_graph(self, banks: tuple[int, ...],
                          kv_tokens: int) -> TaskGraph:
        """Re-install spilled KV after a preemption: stream from the
        channel edge (lowest non-member bank as proxy) into each bank."""
        outside = [bk for bk in range(self.geom.n_banks) if bk not in banks]
        if not outside:
            return ir.materialize(ir.GraphBuilder().build(), self.mode)
        src = self.geom.pe(outside[0], 0)
        b = ir.GraphBuilder()
        rows = self._kv_rows(len(banks), kv_tokens)
        for bk in banks:
            b.move(src, self.geom.pe(bk, 0), rows=rows,
                   tag=f"kvload b{bk}")
        return ir.materialize(b.build(), self.mode)


# --- latency / throughput summaries ---------------------------------------------


def summarize(results, *, percentiles=(50.0, 95.0, 99.0),
              min_samples: int = 2) -> dict:
    """Throughput and latency percentiles over a batch of job results.

    ``makespan_ns`` is the first-arrival → last-finish *span* — the same
    denominator ``throughput_jps`` divides by.  (It used to report the
    absolute last finish time, which only coincides with the span when the
    batch arrives at t=0.)  The absolute window endpoints are exposed
    separately as ``t_start_ns`` / ``t_end_ns``.

    Per-tenant rows carry ``n_jobs`` and ``mean_ns`` alongside ``p99_ns``,
    plus ``p99_reliable``: a percentile over fewer than ``min_samples``
    observations is just that job's latency wearing a p99 costume, so sweep
    guards keying off per-tenant tails must check the flag (or the sample
    count) before trusting the number.  The threshold is echoed top-level
    as ``percentile_min_samples``.

    :class:`SessionResult` entries additionally feed the streaming-serving
    sections: ``ttft_ns`` (time to a turn's first token, one sample per
    turn) and ``tpot_ns`` (time per output token, one sample per
    successive-token gap) are percentile blocks with their own ``n`` /
    ``mean`` / ``p99_reliable``, and ``decode_tps`` is total decoded
    tokens over the span.  With no session results the blocks report
    ``{"n": 0, "p99_reliable": False}`` and ``decode_tps`` is 0.0 — the
    keys are always present, so SLO guards never key-error on a job-only
    batch.
    """
    if min_samples < 1:
        raise ValueError(f"min_samples must be >= 1, got {min_samples}")
    if not results:
        return {"n_jobs": 0, "throughput_jps": 0.0, "latency_ns": {},
                "mean_queue_ns": 0.0, "makespan_ns": 0.0,
                "t_start_ns": 0.0, "t_end_ns": 0.0, "energy_nj": 0.0,
                "percentile_min_samples": min_samples, "per_tenant": {},
                "ttft_ns": {"n": 0, "p99_reliable": False},
                "tpot_ns": {"n": 0, "p99_reliable": False},
                "decode_tps": 0.0}
    lat = np.asarray([r.latency_ns for r in results], dtype=np.float64)
    queue = np.asarray([r.queue_ns for r in results], dtype=np.float64)
    t0 = min(r.arrival_ns for r in results)
    t1 = max(r.finish_ns for r in results)
    span = t1 - t0
    ttft, tpot, n_tokens = [], [], 0
    for r in results:
        ttft.extend(getattr(r, "ttft_samples", ()))
        tpot.extend(getattr(r, "tpot_samples", ()))
        n_tokens += len(getattr(r, "token_ns", ()))

    def _pct_block(samples) -> dict:
        block = {"n": len(samples),
                 "p99_reliable": len(samples) >= min_samples}
        if samples:
            arr = np.asarray(samples, dtype=np.float64)
            block["mean"] = float(arr.mean())
            block.update({f"p{p:g}": float(np.percentile(arr, p))
                          for p in percentiles})
        return block
    per_tenant: dict = {}
    energy_tenant: dict = {}
    total_nj = 0.0
    for r in results:
        per_tenant.setdefault(r.tenant, []).append(r.latency_ns)
        # getattr default keeps pre-energy result rows summarizable
        e = getattr(r, "energy_nj", 0.0)
        energy_tenant[r.tenant] = energy_tenant.get(r.tenant, 0.0) + e
        total_nj += e
    return {
        "n_jobs": len(results),
        "throughput_jps": len(results) / span * 1e9 if span > 0 else 0.0,
        "latency_ns": {f"p{p:g}": float(np.percentile(lat, p))
                       for p in percentiles},
        "mean_latency_ns": float(lat.mean()),
        "mean_queue_ns": float(queue.mean()),
        "makespan_ns": span,
        "t_start_ns": t0,
        "t_end_ns": t1,
        "percentile_min_samples": min_samples,
        "energy_nj": total_nj,
        "ttft_ns": _pct_block(ttft),
        "tpot_ns": _pct_block(tpot),
        "decode_tps": n_tokens / span * 1e9 if span > 0 else 0.0,
        "per_tenant": {
            name: {"n_jobs": len(ls),
                   "mean_ns": float(np.mean(ls)),
                   "p99_ns": float(np.percentile(np.asarray(ls), 99.0)),
                   "p99_reliable": len(ls) >= min_samples,
                   "energy_nj": energy_tenant[name]}
            for name, ls in sorted(per_tenant.items())},
    }
