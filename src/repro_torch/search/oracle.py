"""The memoized, parallel, persistently-cached engine cost oracle (PyTorch
port of ``repro/search/oracle.py``).

A placement search evaluates thousands of candidate virtual->global PE
maps; :class:`PlacementOracle` makes each evaluation as cheap as possible
while keeping one invariant absolute: **every makespan it returns is a
full discrete-event engine result**
(:func:`repro_torch.core.engine.oracle_makespan`).  The layers, from
cheapest to costliest:

1. **in-memory memo** — candidates are keyed by the SHA-256 digest of
   their map; a digest seen before in this process returns instantly.
2. **persistent cache** — an :class:`~repro_torch.search.cache.OracleCache`
   keyed ``fingerprint/geometry/interconnect/digest`` (the graph
   fingerprint is :func:`repro_torch.core.ir.graph_fingerprint` of the
   materialized base, the reference's digest of the same bytes, so a cache
   file the reference wrote answers the port with zero engine evals).
3. **surrogate prune** — the admissible
   :class:`~repro_torch.search.surrogate.LowerBoundModel`: candidates whose
   lower bound already meets the best engine-verified makespan can never
   improve on it and are discarded *unevaluated* (the surrogate prunes;
   it never produces a returned makespan).
4. **engine evaluation** — remap the one materialized base graph
   (:func:`repro_torch.device.partition._remap_ir`, an int-gather) and run
   the engine on the oracle's ``device`` (``cuda`` unless the caller asks
   for the CPU; there is no fallback).  The base is materialized once, the
   :class:`~repro_torch.device.resources.DeviceModel` (and its memoized
   cross-bank plan prices) is shared across every candidate, and the event
   loop is chosen per graph size: the scalar loop for small oracle cells,
   the vectorized loop at scale — both bit-identical by the engine's core
   invariant, so the choice is pure speed.
5. **process pool** — with ``n_workers > 1`` cache-missed candidates fan
   out over a pool of *spawned* workers.  A child forked after the parent
   has touched CUDA cannot use it, so nothing is forked: each worker starts
   a fresh interpreter, rebuilds the evaluator once in its initializer
   from the base graph's arrays, the mode, the geometry, the engine kind
   and the device, and opens its own CUDA context when the device is the
   card.  A pool that cannot start raises (nothing falls back to a serial
   or a host evaluation).  Results are merged in input order keyed by
   candidate digest, so a search is seed-reproducible regardless of
   worker count (``tests/test_torch_pim_search.py`` holds 1, 2 and 4
   workers to the reference's one).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
import weakref

import numpy as np
import torch

from repro_torch.core import engine, ir
from repro_torch.core.ir import TaskGraph
from repro_torch.core.pluto import Interconnect
from repro_torch.device import resolve
from repro_torch.device.geometry import DeviceGeometry
from repro_torch.device.resources import DeviceModel
from repro_torch.search.cache import OracleCache
from repro_torch.search.surrogate import LowerBoundModel

#: graphs at or below this task count evaluate on the scalar event loop —
#: at oracle-cell sizes its per-call overhead beats the vectorized loop's
#: batch setup (both loops are bit-identical)
SCALAR_ORACLE_CUTOVER = 4096

#: seconds a spawned pool may take until every worker has answered; a
#: worker that cannot start (a failed import, a crashed initializer, a
#: main module that spawns on import) would otherwise leave the pool
#: waiting for ever
POOL_START_TIMEOUT_S = 300.0

#: live oracles, for :func:`clear_caches` teardown
_ORACLES: "weakref.WeakSet[PlacementOracle]" = weakref.WeakSet()


class _Evaluator:
    """One engine evaluation of a candidate map over a fixed base graph."""

    def __init__(self, base: TaskGraph, model: DeviceModel,
                 engine_kind: str, device: torch.device):
        self.base, self.model = base, model
        self.engine_kind, self.device = engine_kind, device

    def __call__(self, m) -> float:
        from repro_torch.device import partition
        g = partition._remap_ir(self.base, torch.as_tensor(m,
                                                           dtype=torch.int64))
        return engine.oracle_makespan(g, self.model,
                                      engine=self.engine_kind,
                                      device=self.device)


#: the spawned worker's evaluator, built once by :func:`_worker_init`
_WORKER: _Evaluator | None = None


def _worker_init(fields: dict, mode: Interconnect, geom: DeviceGeometry,
                 engine_kind: str, device: str) -> None:
    """Worker-side initializer: rebuild the evaluator from plain data."""
    global _WORKER
    from repro_torch import convert
    torch.set_num_threads(1)         # the workers share the host's cores
    dev = resolve(device)
    _WORKER = _Evaluator(convert.taskgraph_from_numpy(fields),
                         DeviceModel(mode, geom), engine_kind, dev)


def _worker_ping(_i: int) -> int:
    return os.getpid()


def _pool_eval(buf: bytes) -> float:
    """Worker-side entry: evaluate one candidate map."""
    return _WORKER(torch.from_numpy(np.frombuffer(buf,
                                                  dtype=np.int64).copy()))


def _as_i64(m) -> torch.Tensor:
    return torch.as_tensor(m, dtype=torch.int64).contiguous()


def placement_digest(m) -> str:
    """SHA-256 digest (16 hex chars) of a virtual->global PE map."""
    return hashlib.sha256(_as_i64(m).numpy().tobytes()).hexdigest()[:16]


def geometry_key(geom: DeviceGeometry) -> str:
    """Stable cache-key component naming every geometry field."""
    return (f"{geom.devices}d{geom.channels}c{geom.bank_groups_per_channel}"
            f"g{geom.banks_per_channel}b{geom.pes_per_bank}p")


def resolve_workers(n_workers: int | None) -> int:
    """``None`` -> the usable CPU count (affinity-aware), floored at 1."""
    if n_workers is not None:
        return max(1, int(n_workers))
    try:
        return max(1, len(os.sched_getaffinity(0)))
    except (AttributeError, OSError):
        return max(1, os.cpu_count() or 1)


@dataclasses.dataclass
class OracleStats:
    """Counters over one oracle's lifetime (mirrors the profile hooks)."""

    engine_evals: int = 0
    memo_hits: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    surrogate_prunes: int = 0
    batches: int = 0
    n_workers: int = 1

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class PlacementOracle:
    """Layered makespan oracle over placements of one graph (module doc)."""

    def __init__(self, struct: TaskGraph, mode: Interconnect,
                 geom: DeviceGeometry, *,
                 cache: OracleCache | None = None,
                 model: DeviceModel | None = None,
                 n_workers: int | None = None,
                 profile=None, engine_kind: str | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve(device)
        self.mode, self.geom = mode, geom
        self.base = ir.materialize(struct, mode)
        if model is None:
            model = DeviceModel(mode, geom)
        elif model.mode is not mode or model.geom != geom:
            raise ValueError(
                f"model is for ({model.mode}, {model.geom.describe()}), "
                f"not ({mode}, {geom.describe()})")
        self.model = model
        self.engine_kind = engine_kind or (
            "scalar" if self.base.n <= SCALAR_ORACLE_CUTOVER else "vector")
        self.lb_model = LowerBoundModel(self.base, geom)
        self.cache = cache
        self.profile = profile
        self.n_workers = resolve_workers(n_workers)
        self.stats = OracleStats(n_workers=self.n_workers)
        self.key_prefix = (f"{ir.graph_fingerprint(self.base)}/"
                           f"{geometry_key(geom)}/{mode.value}")
        self._eval = _Evaluator(self.base, model, self.engine_kind,
                                self.device)
        self._memo: dict[str, float] = {}
        self._lb_memo: dict[str, float] = {}
        self._pool = None
        #: wall seconds the pool took to start and answer every worker's
        #: first call (None until a batch has used the pool)
        self.pool_start_s: float | None = None
        _ORACLES.add(self)

    # --- keys -------------------------------------------------------------------

    def cache_key(self, digest: str) -> str:
        return f"{self.key_prefix}/{digest}"

    # --- the layers -------------------------------------------------------------

    def _engine_eval(self, m) -> float:
        return self._eval(m)

    def lower_bound(self, m, digest: str | None = None) -> float:
        if digest is None:
            digest = placement_digest(m)
        lb = self._lb_memo.get(digest)
        if lb is None:
            lb = self._lb_memo[digest] = self.lb_model.lower_bound(_as_i64(m))
        return lb

    def start_pool(self) -> float:
        """Start the spawned worker pool (idempotent); returns the seconds
        it took until ``n_workers`` first calls had come back."""
        if self._pool is None:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor

            from repro_torch import convert
            t0 = time.perf_counter()
            self._pool = ProcessPoolExecutor(
                self.n_workers, mp_context=mp.get_context("spawn"),
                initializer=_worker_init,
                initargs=(convert.taskgraph_to_numpy(self.base), self.mode,
                          self.geom, self.engine_kind, str(self.device)))
            try:
                # a worker whose initializer fails breaks the pool, and
                # one that never comes up times out: either raises
                list(self._pool.map(_worker_ping, range(self.n_workers),
                                    timeout=POOL_START_TIMEOUT_S))
            except BaseException as e:
                self._kill_pool()
                raise RuntimeError(
                    f"the oracle's pool of {self.n_workers} spawned workers "
                    f"on {self.device} did not start: {e!r}") from e
            self.pool_start_s = time.perf_counter() - t0
        return self.pool_start_s

    def _pool_map(self, maps: list) -> list[float]:
        self.start_pool()
        payloads = [_as_i64(m).numpy().tobytes() for m in maps]
        chunk = max(1, -(-len(payloads) // (4 * self.n_workers)))
        return list(self._pool.map(_pool_eval, payloads, chunksize=chunk))

    # --- public evaluation ------------------------------------------------------

    def evaluate(self, maps, *, prune_at: float | None = None
                 ) -> list[float | None]:
        """Makespans aligned with ``maps``; ``None`` marks a pruned entry.

        Candidates whose memo/cache layer already holds a verdict return it
        (no pruning — known values are free).  Remaining candidates with
        ``lower_bound >= prune_at`` are discarded: they provably cannot
        *improve* on an engine-verified ``prune_at``, so the search never
        needs their exact cost.  Everything else is engine-evaluated (in
        the worker pool when configured), merged back in input order by
        digest, and written through to the memo and the persistent cache.
        """
        digests = [placement_digest(m) for m in maps]
        out: list[float | None] = [None] * len(maps)
        todo: dict[str, torch.Tensor] = {}
        memo_hits = cache_hits = prunes = 0
        for i, (d, m) in enumerate(zip(digests, maps)):
            v = self._memo.get(d)
            if v is not None:
                out[i] = v
                memo_hits += 1
                continue
            if self.cache is not None:
                v = self.cache.get(self.cache_key(d))
                if isinstance(v, (int, float)):
                    out[i] = self._memo[d] = float(v)
                    cache_hits += 1
                    continue
            if prune_at is not None and d not in todo \
                    and self.lower_bound(m, d) >= prune_at:
                prunes += 1
                continue
            todo.setdefault(d, _as_i64(m))
        fresh = list(todo.items())
        if fresh:
            if self.n_workers > 1 and len(fresh) > 1:
                values = self._pool_map([m for _, m in fresh])
            else:
                values = [self._engine_eval(m) for _, m in fresh]
            for (d, _), v in zip(fresh, values):
                self._memo[d] = v
                if self.cache is not None:
                    self.cache.put(self.cache_key(d), v)
            for i, d in enumerate(digests):
                if out[i] is None and d in self._memo:
                    out[i] = self._memo[d]
        self.stats.engine_evals += len(fresh)
        self.stats.memo_hits += memo_hits
        self.stats.cache_hits += cache_hits
        self.stats.cache_misses += len(fresh)
        self.stats.surrogate_prunes += prunes
        self.stats.batches += 1
        if self.profile is not None:
            self.profile.record_oracle(
                evals=len(fresh), memo_hits=memo_hits,
                cache_hits=cache_hits, cache_misses=len(fresh),
                prunes=prunes, workers=self.n_workers)
        return out

    def evaluate_one(self, m) -> float:
        """Unpruned single-candidate evaluation (always returns a float)."""
        return self.evaluate([m])[0]

    # --- teardown ---------------------------------------------------------------

    def forget(self) -> None:
        """Drop the in-memory memo layers (persistent cache untouched)."""
        self._memo.clear()
        self._lb_memo.clear()

    def _kill_pool(self) -> None:
        pool, self._pool = self._pool, None
        procs = list((getattr(pool, "_processes", None) or {}).values())
        for proc in procs:
            proc.kill()
        pool.shutdown(wait=False, cancel_futures=True)
        for proc in procs:
            proc.join(timeout=10.0)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def __del__(self):  # pragma: no cover - interpreter-shutdown best effort
        try:
            self.close()
        except Exception:
            pass


def clear_caches() -> None:
    """Teardown hook for :func:`repro_torch.device.batch.clear_caches`.

    Forgets every live oracle's memo and surrogate layers and every
    :class:`OracleCache`'s in-memory state.  On-disk cache *files* are kept
    — they are the persistent layer; deleting them is the owner's call
    (:meth:`OracleCache.clear`).
    """
    from repro_torch.search import cache as _cache
    for o in list(_ORACLES):
        o.forget()
    _cache.clear_loaded()
