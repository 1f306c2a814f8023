"""The search-driven place stage: :class:`SearchPlacePass` (PyTorch port of
``repro/passes/search.py``).

Drop-in replacement for :class:`~repro_torch.passes.placement.PlacePass` /
:class:`~repro_torch.passes.placement.LeasePlacePass` that, instead of
applying one greedy policy, runs the cost-driven search of
:mod:`repro_torch.search` (beam + simulated annealing, engine as the
makespan oracle, seeded from every greedy policy).  The pass stays pure
``TaskGraph -> TaskGraph``; the searched map is applied with the same
:func:`repro_torch.device.partition._remap_ir` gather the greedy passes
use, so `validate -> search-place -> optimize -> legalize` composes with
every existing optimization pass unchanged.

Because the search seeds from (and engine-evaluates) every greedy policy,
the placed graph is never worse than the best greedy placement, and the
rewrite log records the decision: seed policy, engine-verified makespans
before/after, candidate counts, and the winning placement digest.  The
search's oracle runs on ``config.device`` (``cuda`` unless the caller asks
for the CPU).
"""

from __future__ import annotations

from repro_torch.core.ir import TaskGraph
from repro_torch.passes.pipeline import Pass, Rewrite, RewriteLog


class SearchPlacePass(Pass):
    """Map virtual PEs onto the device via the cost-driven search."""

    name = "search_place"
    stage = "place"

    def __init__(self, mode, geom, *, banks=None, config=None, oracle=None):
        from repro_torch.search import SearchConfig
        self.mode = mode
        self.geom = geom
        self.banks = tuple(banks) if banks is not None else None
        self.config = config or SearchConfig()
        self.oracle = oracle          # optional pre-warmed shared oracle
        #: the last run's :class:`repro_torch.search.SearchResult`
        self.last_result = None

    def describe(self) -> str:
        lease = "" if self.banks is None \
            else f":banks={','.join(map(str, self.banks))}"
        return (f"search_place[{self.mode.value}@{self.geom.describe()}"
                f"{lease}|{self.config.describe()}]")

    def run(self, g: TaskGraph, log: RewriteLog) -> TaskGraph:
        from repro_torch.device import partition  # partition imports passes
        from repro_torch.search import search_pe_map
        res = search_pe_map(g, self.mode, self.geom, banks=self.banks,
                            config=self.config, oracle=self.oracle)
        self.last_result = res
        log.add(Rewrite(
            self.name, "place", uid=-1,
            detail=(f"seed={res.incumbent_policy} "
                    f"{res.incumbent_makespan_ns:.1f}ns -> "
                    f"{res.makespan_ns:.1f}ns "
                    f"({res.improvement * 100:.2f}% better, "
                    f"{res.n_candidates} candidates, "
                    f"{res.stats['engine_evals']} engine evals, "
                    f"{res.stats['surrogate_prunes']} pruned, "
                    f"{res.stats['cache_hits']} cache hits) "
                    f"digest={res.digest}")))
        return partition._remap_ir(g, res.pe_map)
