"""Cost-driven placement search: beam + simulated annealing over PE maps
(PyTorch port of ``repro/search/place.py``).

The place stage's three greedy policies (:mod:`repro_torch.device.partition`)
each encode one fixed intuition; this module closes the ROADMAP's
search-based-placement loop by treating placement as an optimization
problem with the discrete-event engine as the cost oracle.  The search:

1. **seeds** from every greedy policy, keeping the best as the incumbent —
   so the result can *never* be worse than the best greedy placement
   (property-tested in ``tests/test_torch_pim_search.py``);
2. runs a short **beam search**: each surviving state proposes a few
   neighbors, candidates are digest-deduplicated, surrogate-pruned against
   the engine-verified best, batch-evaluated by the oracle, and the best
   ``beam_width`` states survive (ties broken by digest, so ordering is
   total and reproducible);
3. **refines** the winner by simulated annealing: batched proposals per
   round, greedy acceptance when better, Metropolis acceptance when worse,
   geometric temperature decay.

Budgets are expressed in *rounds and proposals* — never wall-clock — so
the same seed replays the same trajectory on any machine at any load
(``chip_smoke.py``'s ``pim-runtime`` phase times it *outside* the search).
All randomness flows through one NumPy generator seeded by
``SearchConfig.seed`` — PCG64, which ``torch.Generator`` cannot reproduce,
so the port keeps it and every searched map equals the reference's; the
maps themselves are host int64 tensors.  Oracle batches merge by digest in
input order, so the trajectory is identical at any worker count.

Neighborhood moves (all bijection-preserving swaps over the candidate
slot set, which is the whole device or a leased bank subset):

* ``swap_pes``   — swap one *used* virtual PE's slot with any other slot;
* ``swap_banks`` — swap two whole virtual banks' slot blocks;
* ``cluster_pull`` — pick a move edge and pull its producer into the
  consumer's physical bank (displacing whoever held that slot), the
  targeted traffic-reduction move the greedy policies cannot express.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.ir import MOVE, NONE_SENTINEL, OP, TaskGraph
from repro_torch.core.pluto import Interconnect
from repro_torch.device.geometry import DeviceGeometry
from repro_torch.search.cache import OracleCache
from repro_torch.search.oracle import PlacementOracle, placement_digest

_I64 = torch.int64


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Deterministic search budget and behavior knobs (hashable).

    ``device`` is where the oracle's engine runs (``cuda`` unless the
    caller asks for the CPU); like ``n_workers`` and ``cache_path`` it
    changes where and how fast candidates are priced, never the search,
    so :meth:`describe` leaves it out.
    """

    seed: int = 0
    beam_width: int = 4
    beam_rounds: int = 4
    neighbors_per_state: int = 8
    sa_rounds: int = 12
    sa_proposals: int = 8
    sa_temp: float = 0.02        # initial temperature, x incumbent makespan
    sa_decay: float = 0.8
    prune: bool = True           # admissible-surrogate pruning on/off
    n_workers: int | None = None
    cache_path: str | None = None
    device: str = "cuda"

    def describe(self) -> str:
        """Stable descriptor (feeds pass/pipeline fingerprints)."""
        return (f"seed={self.seed},beam={self.beam_width}x{self.beam_rounds}"
                f"x{self.neighbors_per_state},sa={self.sa_rounds}"
                f"x{self.sa_proposals}@{self.sa_temp:g}/{self.sa_decay:g},"
                f"prune={int(self.prune)}")


@dataclasses.dataclass
class SearchResult:
    """Outcome of one placement search (everything a guard needs)."""

    pe_map: torch.Tensor         # virtual PE id -> global PE id (int64)
    makespan_ns: float           # engine-verified makespan of pe_map
    digest: str                  # placement_digest(pe_map)
    incumbent_policy: str        # best greedy policy the search seeded from
    incumbent_makespan_ns: float
    greedy: dict[str, float]     # every greedy policy's makespan
    n_candidates: int            # distinct placements considered
    stats: dict                  # OracleStats.as_dict()

    @property
    def improvement(self) -> float:
        """Fractional gain over the greedy incumbent (>= 0 always)."""
        if self.incumbent_makespan_ns <= 0:
            return 0.0
        return 1.0 - self.makespan_ns / self.incumbent_makespan_ns


def _used_virtual_pes(g: TaskGraph) -> torch.Tensor:
    parts = [g.pe[(g.kinds == OP) & (g.pe != NONE_SENTINEL)],
             g.src[(g.kinds == MOVE) & (g.src != NONE_SENTINEL)],
             g.dst_flat]
    return torch.unique(torch.cat(parts), sorted=True).to(_I64)


def _move_pairs(g: TaskGraph) -> tuple[torch.Tensor, torch.Tensor]:
    counts = torch.diff(g.dst_indptr)
    owners = torch.repeat_interleave(torch.arange(g.n, dtype=_I64), counts)
    ok = (g.kinds[owners] == MOVE) & (g.src[owners] != NONE_SENTINEL)
    return g.src[owners][ok].to(_I64), g.dst_flat[ok].to(_I64)


class _Neighborhood:
    """Seeded proposal generator over bijective slot maps."""

    def __init__(self, struct: TaskGraph, ppb: int, n_virtual_banks: int,
                 rng: np.random.Generator):
        self.rng = rng
        self.ppb = ppb
        self.nvb = n_virtual_banks
        self.used = _used_virtual_pes(struct)
        self.mv_src, self.mv_dst = _move_pairs(struct)
        self.n_virtual = ppb * n_virtual_banks

    def propose(self, m: torch.Tensor) -> torch.Tensor:
        out = m.clone()
        n_mv = self.mv_src.numel()
        kinds = 3 if n_mv else 2
        kind = int(self.rng.integers(kinds)) if self.nvb > 1 \
            else (0 if kinds < 3 else int(self.rng.integers(2)) * 2)
        if kind == 0 and self.used.numel():           # swap_pes
            i = int(self.used[int(self.rng.integers(self.used.numel()))])
            j = int(self.rng.integers(self.n_virtual))
            out[[i, j]] = out[[j, i]]
        elif kind == 1:                                # swap_banks
            b1, b2 = (int(b) for b in self.rng.choice(self.nvb, size=2,
                                                      replace=False))
            s1 = slice(b1 * self.ppb, (b1 + 1) * self.ppb)
            s2 = slice(b2 * self.ppb, (b2 + 1) * self.ppb)
            out[s1], out[s2] = out[s2].clone(), out[s1].clone()
        elif kind == 2:                                # cluster_pull
            k = int(self.rng.integers(n_mv))
            vsrc, vdst = int(self.mv_src[k]), int(self.mv_dst[k])
            target_bank = int(out[vdst]) // self.ppb
            slots = torch.nonzero(out // self.ppb == target_bank).flatten()
            j = int(slots[int(self.rng.integers(slots.numel()))])
            out[[vsrc, j]] = out[[j, vsrc]]
        return out


def _greedy_maps(struct: TaskGraph, geom: DeviceGeometry,
                 banks) -> dict[str, torch.Tensor]:
    from repro_torch.device import partition
    out = {}
    for policy in partition.POLICIES:
        if banks is None:
            m = partition.pe_map(geom, policy, struct)
        else:
            m = partition.lease_pe_map(geom, banks, policy, struct)
        out[policy] = torch.tensor(m, dtype=_I64)
    return out


def search_pe_map(struct: TaskGraph, mode: Interconnect,
                  geom: DeviceGeometry, *, banks=None,
                  config: SearchConfig | None = None,
                  oracle: PlacementOracle | None = None,
                  model=None, profile=None) -> SearchResult:
    """Search a virtual->global PE map for ``struct`` (see module doc).

    ``banks`` restricts the slot set to a leased bank subset, exactly the
    virtual-device view :func:`repro_torch.device.partition.lease_pe_map`
    gives online tenants.  A caller-provided ``oracle`` (already warmed,
    maybe pool-backed, on its own device) is reused as-is; otherwise one is
    built from ``config`` (its workers, cache and device) and closed on
    return.
    """
    config = config or SearchConfig()
    own_oracle = oracle is None
    if own_oracle:
        cache = OracleCache(Path(config.cache_path)) \
            if config.cache_path else None
        oracle = PlacementOracle(struct, mode, geom, cache=cache,
                                 model=model, n_workers=config.n_workers,
                                 profile=profile, device=config.device)
    try:
        return _search(struct, geom, banks, config, oracle)
    finally:
        if own_oracle:
            oracle.close()


def _search(struct: TaskGraph, geom: DeviceGeometry, banks,
            config: SearchConfig, oracle: PlacementOracle) -> SearchResult:
    rng = np.random.default_rng(config.seed)
    seeds = _greedy_maps(struct, geom, banks)
    n_virtual_banks = geom.n_banks if banks is None else len(banks)
    hood = _Neighborhood(struct, geom.pes_per_bank, n_virtual_banks, rng)

    # --- greedy incumbents (never pruned: the baseline must be exact) ----------
    policies = list(seeds)
    mks = oracle.evaluate([seeds[p] for p in policies])
    greedy = {p: float(v) for p, v in zip(policies, mks)}
    incumbent_policy = min(policies, key=lambda p: greedy[p])
    incumbent_mk = greedy[incumbent_policy]

    seen: set[str] = set()
    states: list[tuple[float, str, torch.Tensor]] = []
    for p in policies:
        d = placement_digest(seeds[p])
        if d not in seen:
            seen.add(d)
            states.append((greedy[p], d, seeds[p]))
    states.sort(key=lambda s: (s[0], s[1]))
    best_mk, best_d, best_m = states[0]

    # --- beam phase -------------------------------------------------------------
    beam = states[:config.beam_width]
    for _ in range(config.beam_rounds):
        cand: list[tuple[str, torch.Tensor]] = []
        for _, _, m in beam:
            for _ in range(config.neighbors_per_state):
                m2 = hood.propose(m)
                d2 = placement_digest(m2)
                if d2 in seen:
                    continue
                seen.add(d2)
                cand.append((d2, m2))
        if not cand:
            break
        vals = oracle.evaluate(
            [m for _, m in cand],
            prune_at=best_mk if config.prune else None)
        pool = beam + [(float(v), d, m)
                       for (d, m), v in zip(cand, vals) if v is not None]
        pool.sort(key=lambda s: (s[0], s[1]))
        beam = pool[:config.beam_width]
        if beam[0][0] < best_mk:
            best_mk, best_d, best_m = beam[0]

    # --- simulated-annealing refinement ----------------------------------------
    cur_mk, cur_m = best_mk, best_m
    temp = config.sa_temp * incumbent_mk
    for _ in range(config.sa_rounds):
        batch: dict[str, torch.Tensor] = {}
        for _ in range(config.sa_proposals):
            m2 = hood.propose(cur_m)
            batch.setdefault(placement_digest(m2), m2)
        seen.update(batch)
        items = sorted(batch)                    # digest order: total, stable
        vals = oracle.evaluate(
            [batch[d] for d in items],
            prune_at=best_mk if config.prune else None)
        scored = [(float(v), d) for d, v in zip(items, vals)
                  if v is not None]
        if scored:
            mk, d = min(scored)
            accept = mk < cur_mk or (
                temp > 0.0
                and rng.random() < math.exp((cur_mk - mk) / temp))
            if accept:
                cur_mk, cur_m = mk, batch[d]
            if mk < best_mk:
                best_mk, best_d, best_m = mk, d, batch[d]
        temp *= config.sa_decay

    # the returned makespan is always an engine verdict; the incumbent seed
    # is in the evaluated pool, so searched <= best greedy by construction
    return SearchResult(
        pe_map=best_m, makespan_ns=best_mk, digest=best_d,
        incumbent_policy=incumbent_policy,
        incumbent_makespan_ns=incumbent_mk, greedy=greedy,
        n_candidates=len(seen), stats=oracle.stats.as_dict())
