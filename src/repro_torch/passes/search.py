"""The search-driven place stage: :class:`SearchPlacePass` (PyTorch port of
``repro/passes/search.py``).

Drop-in replacement for :class:`~repro_torch.passes.placement.PlacePass` /
:class:`~repro_torch.passes.placement.LeasePlacePass` that, instead of
applying one greedy policy, runs the cost-driven placement search (beam +
simulated annealing, engine as the makespan oracle, seeded from every
greedy policy) and applies the searched map with the same
:func:`repro_torch.device.partition._remap_ir` gather the greedy passes use.

The search layer (``repro_torch.search``) is not ported yet (ROADMAP
Queue 1 item 17).  Until it is, the pass is constructed and described as
in the reference, so pipelines that hold it build, and :meth:`run` raises
``NotImplementedError``.
"""

from __future__ import annotations

import importlib
import importlib.util

import torch

from repro_torch.core.ir import TaskGraph
from repro_torch.passes.pipeline import Pass, Rewrite, RewriteLog

#: the module that will hold the placement search, once it is ported
_SEARCH = "repro_torch.search"


def search_layer():
    """The port's search module; raises until ROADMAP Queue 1 item 17
    (``search/``) is ported."""
    if importlib.util.find_spec(_SEARCH) is None:
        raise NotImplementedError(
            "the placement search is not ported yet (ROADMAP Queue 1 item "
            "17, search/); use a greedy policy (PlacePass / device_pipeline)")
    return importlib.import_module(_SEARCH)


class SearchPlacePass(Pass):
    """Map virtual PEs onto the device via the cost-driven search."""

    name = "search_place"
    stage = "place"

    def __init__(self, mode, geom, *, banks=None, config=None, oracle=None):
        self.mode = mode
        self.geom = geom
        self.banks = tuple(banks) if banks is not None else None
        #: None: the search layer's default configuration
        self.config = config
        self.oracle = oracle          # optional pre-warmed shared oracle
        #: the last run's search result (diagnostics)
        self.last_result = None

    def describe(self) -> str:
        lease = "" if self.banks is None \
            else f":banks={','.join(map(str, self.banks))}"
        cfg = "default" if self.config is None else self.config.describe()
        return (f"search_place[{self.mode.value}@{self.geom.describe()}"
                f"{lease}|{cfg}]")

    def run(self, g: TaskGraph, log: RewriteLog) -> TaskGraph:
        from repro_torch.device import partition  # partition imports passes
        search = search_layer()
        res = search.search_pe_map(g, self.mode, self.geom, banks=self.banks,
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
        return partition._remap_ir(g, torch.as_tensor(res.pe_map,
                                                      dtype=torch.int64))
