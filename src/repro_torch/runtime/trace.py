"""Workload traces for the online serving runtime (PyTorch port of
``repro/runtime/trace.py``).

The serving simulator consumes *job streams* rather than one closed task
graph: each :class:`JobRequest` names a tenant, the tenant names one of the
five paper apps (mm / pmm / ntt / bfs / dfs) with a problem size, a bank
demand, and a priority.  Two arrival disciplines are modeled:

* **open loop** (:func:`open_loop_trace`): every tenant is an independent
  Poisson process — arrivals keep coming whether or not the device keeps
  up, which is what exposes queueing collapse past saturation (the regime
  where LISA's circuit-switched moves cost it sustainable load);
* **closed loop** (:class:`ClosedLoopSource`): every tenant holds a fixed
  number of jobs in flight and issues the next one a think time after a
  completion — throughput self-limits to the service rate, the classic
  interactive-user model.

Everything is deterministic: arrivals derive from
``numpy.random.default_rng((seed, tenant_index))``, so a trace is a pure
function of (tenant list, seed, load) — the serving benchmarks replay the
*identical* arrival sequence under both interconnects and every admission
policy.

The streams stay NumPy's PCG64 generators: ``torch.Generator`` cannot
reproduce them, and the arrival times are data the reference's runs are
held to.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: the five builtin Fig-8 applications; model archs registered by the
#: inference frontend (:mod:`repro_torch.frontend`) are equally valid tenant
#: apps — :func:`known_apps` lists both
TRACE_APPS = ("mm", "pmm", "ntt", "bfs", "dfs")


def known_apps() -> tuple[str, ...]:
    """Every app a tenant may name: Fig-8 builtins + registered models."""
    from repro_torch.core import taskgraph
    return taskgraph.known_apps()


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant: an app, a problem size, a bank demand, and traffic shape.

    ``kw`` holds the app builder kwargs as sorted items (hashable, like
    :class:`repro_torch.device.batch.SweepConfig`); build with :meth:`make`.
    """

    name: str
    app: str
    kw: tuple = ()
    rate_jps: float = 50.0       # open-loop Poisson arrival rate (jobs/s)
    priority: int = 0            # larger = more urgent (admission policy)
    banks: int = 1               # banks leased per job
    concurrency: int = 1         # closed-loop jobs kept in flight
    think_ns: float = 0.0        # closed-loop mean think time

    @classmethod
    def make(cls, name: str, app: str, *, rate_jps: float = 50.0,
             priority: int = 0, banks: int = 1, concurrency: int = 1,
             think_ns: float = 0.0, **kw) -> "TenantSpec":
        if app not in TRACE_APPS and app not in known_apps():
            raise ValueError(
                f"unknown app {app!r}; pick one of {known_apps()}")
        if rate_jps < 0 or banks < 1 or concurrency < 1 or think_ns < 0:
            raise ValueError(
                f"invalid tenant shape for {name!r}: rate_jps={rate_jps}, "
                f"banks={banks}, concurrency={concurrency}, "
                f"think_ns={think_ns}")
        return cls(name, app, tuple(sorted(kw.items())), rate_jps, priority,
                   banks, concurrency, think_ns)

    @property
    def kwargs(self) -> dict:
        return dict(self.kw)

    def scaled(self, load: float) -> "TenantSpec":
        """This tenant with its open-loop rate multiplied by ``load``."""
        return dataclasses.replace(self, rate_jps=self.rate_jps * load)


@dataclasses.dataclass(frozen=True)
class JobRequest:
    """One job arrival of a tenant's stream."""

    arrival_ns: float
    tenant: TenantSpec
    seq: int                     # per-tenant sequence number

    @property
    def sort_key(self) -> tuple:
        # total order: simultaneous arrivals break by tenant name then seq,
        # never by object identity
        return (self.arrival_ns, self.tenant.name, self.seq)


def _tenant_rng(seed: int, index: int) -> np.random.Generator:
    return np.random.default_rng((seed, index))


def open_loop_trace(tenants, *, jobs_per_tenant: int | None = None,
                    horizon_ns: float | None = None, seed: int = 0,
                    load: float = 1.0) -> list[JobRequest]:
    """Merged Poisson arrival streams, one per tenant, sorted by arrival.

    Exactly one of ``jobs_per_tenant`` (fixed-count streams, the benchmark
    default — every load level completes the same job population) or
    ``horizon_ns`` (fixed-window streams) bounds the trace.  ``load``
    scales every tenant's rate, leaving the per-tenant mix intact.
    """
    if (jobs_per_tenant is None) == (horizon_ns is None):
        raise ValueError(
            "exactly one of jobs_per_tenant / horizon_ns must be given")
    out: list[JobRequest] = []
    for ti, t in enumerate(tenants):
        rate = t.rate_jps * load
        if rate <= 0.0:
            if jobs_per_tenant is not None:
                # a zero-rate tenant can never produce its fixed job count;
                # silently emitting an empty stream would break the "every
                # load level completes the same job population" invariant
                # the cross-load comparisons rely on
                raise ValueError(
                    f"tenant {t.name!r} has arrival rate {rate} jobs/s "
                    f"(rate_jps={t.rate_jps}, load={load}) but "
                    f"jobs_per_tenant={jobs_per_tenant} bounding requires "
                    "every tenant to complete its stream; give it a "
                    "positive rate or bound by horizon_ns")
            continue
        rng = _tenant_rng(seed, ti)
        mean_ns = 1e9 / rate
        ts = 0.0
        seq = 0
        while True:
            if jobs_per_tenant is not None and seq >= jobs_per_tenant:
                break
            ts += float(rng.exponential(mean_ns))
            if horizon_ns is not None and ts >= horizon_ns:
                break
            out.append(JobRequest(ts, t, seq))
            seq += 1
    out.sort(key=lambda r: r.sort_key)
    return out


class ClosedLoopSource:
    """Fixed-concurrency tenants: each completion issues the next arrival.

    Every tenant starts ``concurrency`` jobs at t=0 and replaces each
    completed job after an exponential think time (mean ``think_ns``; zero
    means immediate re-issue), until its ``jobs_per_tenant`` budget is
    spent.  Deterministic per (tenants, seed).
    """

    def __init__(self, tenants, *, jobs_per_tenant: int, seed: int = 0):
        if jobs_per_tenant < 1:
            raise ValueError("jobs_per_tenant must be >= 1")
        self._tenants = list(tenants)
        self._rngs = {t.name: _tenant_rng(seed, i)
                      for i, t in enumerate(self._tenants)}
        self._issued = {t.name: 0 for t in self._tenants}
        self._budget = jobs_per_tenant

    def initial(self) -> list[JobRequest]:
        """The t=0 arrivals: ``concurrency`` jobs per tenant."""
        out = []
        for t in self._tenants:
            for _ in range(min(t.concurrency, self._budget)):
                out.append(self._issue(t, 0.0))
        out.sort(key=lambda r: r.sort_key)
        return out

    def on_complete(self, req: JobRequest, now_ns: float
                    ) -> JobRequest | None:
        """The follow-up arrival for a completed job (None when spent)."""
        t = req.tenant
        if self._issued[t.name] >= self._budget:
            return None
        think = float(self._rngs[t.name].exponential(t.think_ns)) \
            if t.think_ns > 0.0 else 0.0
        return self._issue(t, now_ns + think)

    def _issue(self, t: TenantSpec, at: float) -> JobRequest:
        seq = self._issued[t.name]
        self._issued[t.name] = seq + 1
        return JobRequest(at, t, seq)


# --- session streams (continuous batching) ---------------------------------------


@dataclasses.dataclass(frozen=True)
class SessionSpec:
    """One conversational tenant class: a model, a context shape, traffic.

    Where a :class:`TenantSpec` names closed jobs, a session names a
    *conversation*: ``turns`` rounds of (prompt_tokens prefill →
    decode_tokens generated one spliced step at a time), with the KV cache
    resident in banks between turns and ``think_ns`` of user think time
    separating them.  ``app`` must be a registered model arch — sessions
    lower through :func:`repro_torch.frontend.lower.decode_step`, which only the
    model frontend parameterizes by KV length.
    """

    name: str
    app: str
    kw: tuple = ()               # extra lowering kwargs (n_layers, ...)
    prompt_tokens: int = 512
    decode_tokens: int = 32
    turns: int = 1
    think_ns: float = 0.0        # between-turn user think time
    rate_sps: float = 20.0       # open-loop session arrival rate (sess/s)
    priority: int = 0
    concurrency: int = 1         # closed-loop sessions kept live

    @classmethod
    def make(cls, name: str, app: str, *, prompt_tokens: int = 512,
             decode_tokens: int = 32, turns: int = 1, think_ns: float = 0.0,
             rate_sps: float = 20.0, priority: int = 0,
             concurrency: int = 1, **kw) -> "SessionSpec":
        from repro_torch.frontend.lower import MODEL_APPS
        if app not in MODEL_APPS:
            raise ValueError(
                f"session app must be a registered model arch (decode_step "
                f"is KV-parameterized); got {app!r}, known: {MODEL_APPS}")
        if prompt_tokens < 1 or decode_tokens < 1 or turns < 1:
            raise ValueError(
                f"invalid session shape for {name!r}: prompt_tokens="
                f"{prompt_tokens}, decode_tokens={decode_tokens}, "
                f"turns={turns}")
        if rate_sps < 0 or think_ns < 0 or concurrency < 1:
            raise ValueError(
                f"invalid session traffic for {name!r}: rate_sps="
                f"{rate_sps}, think_ns={think_ns}, "
                f"concurrency={concurrency}")
        return cls(name, app, tuple(sorted(kw.items())), prompt_tokens,
                   decode_tokens, turns, think_ns, rate_sps, priority,
                   concurrency)

    @property
    def kwargs(self) -> dict:
        return dict(self.kw)

    def scaled(self, load: float) -> "SessionSpec":
        """This spec with its open-loop session rate scaled by ``load``."""
        return dataclasses.replace(self, rate_sps=self.rate_sps * load)


@dataclasses.dataclass(frozen=True)
class SessionRequest:
    """One session arrival of a spec's stream."""

    arrival_ns: float
    session: SessionSpec
    seq: int                     # per-spec sequence number

    @property
    def sort_key(self) -> tuple:
        return (self.arrival_ns, self.session.name, self.seq)


def session_trace(specs, *, sessions_per_spec: int, seed: int = 0,
                  load: float = 1.0) -> list[SessionRequest]:
    """Merged Poisson session-arrival streams, one per spec.

    The exact analogue of :func:`open_loop_trace` at session granularity:
    deterministic per (specs, seed, load), every load level starts the same
    session population, ``load`` scales every spec's arrival rate.
    """
    if sessions_per_spec < 1:
        raise ValueError(
            f"sessions_per_spec must be >= 1, got {sessions_per_spec}")
    out: list[SessionRequest] = []
    for si, s in enumerate(specs):
        rate = s.rate_sps * load
        if rate <= 0.0:
            raise ValueError(
                f"session spec {s.name!r} has arrival rate {rate} sess/s "
                f"(rate_sps={s.rate_sps}, load={load}); fixed-count "
                "session streams need a positive rate")
        rng = _tenant_rng(seed, si)
        mean_ns = 1e9 / rate
        ts = 0.0
        for seq in range(sessions_per_spec):
            ts += float(rng.exponential(mean_ns))
            out.append(SessionRequest(ts, s, seq))
    out.sort(key=lambda r: r.sort_key)
    return out


class MultiTurnSource:
    """Closed-loop conversations: a finished session spawns the next user.

    Every spec keeps ``concurrency`` sessions live from t=0; when one
    session's final turn completes, the next session of that spec arrives
    after an exponential think time (mean ``think_ns``) — the interactive
    fleet whose decode streams stay resident while fresh prefill flows in
    around them.  Deterministic per (specs, seed).
    """

    def __init__(self, specs, *, sessions_per_spec: int, seed: int = 0):
        if sessions_per_spec < 1:
            raise ValueError("sessions_per_spec must be >= 1")
        self._specs = list(specs)
        self._rngs = {s.name: _tenant_rng(seed, i)
                      for i, s in enumerate(self._specs)}
        self._issued = {s.name: 0 for s in self._specs}
        self._budget = sessions_per_spec

    def initial(self) -> list[SessionRequest]:
        out = []
        for s in self._specs:
            for _ in range(min(s.concurrency, self._budget)):
                out.append(self._issue(s, 0.0))
        out.sort(key=lambda r: r.sort_key)
        return out

    def on_session_complete(self, req: SessionRequest, now_ns: float
                            ) -> SessionRequest | None:
        s = req.session
        if self._issued[s.name] >= self._budget:
            return None
        think = float(self._rngs[s.name].exponential(s.think_ns)) \
            if s.think_ns > 0.0 else 0.0
        return self._issue(s, now_ns + think)

    def _issue(self, s: SessionSpec, at: float) -> SessionRequest:
        seq = self._issued[s.name]
        self._issued[s.name] = seq + 1
        return SessionRequest(at, s, seq)
