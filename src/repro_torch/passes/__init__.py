"""Pass-based IR optimizer: placement and move optimization as a pipeline
(PyTorch port of ``repro/passes/``).

The app builders (:mod:`repro_torch.core.taskgraph`) and the model
frontend (:mod:`repro_torch.frontend`) emit *logical* graphs on virtual PEs;
this package turns them physical through a staged compiler pipeline::

    validate -> place -> optimize -> legalize

Placement passes wrap the existing :mod:`repro_torch.device.partition` policies
(``round_robin`` / ``locality_first`` / ``bandwidth_balanced`` and bank-set
leases); optimization passes exploit post-placement knowledge to delete
self-moves, coalesce same-value hand-offs into broadcasts, and fuse
store-and-forward move chains.  Every pass is a pure ``TaskGraph -> TaskGraph``
function with a recorded rewrite log.

Quickstart::

    from repro_torch import passes
    from repro_torch.core import taskgraph
    from repro_torch.device.geometry import DeviceGeometry

    geom = DeviceGeometry(channels=1, banks_per_channel=4)
    pipe = passes.device_pipeline(geom, policy="locality_first",
                                  opt=passes.DEFAULT_OPT)
    g, log = pipe.run(taskgraph.structural("qwen2-moe-a2.7b",
                                           n_pes=geom.total_pes,
                                           phase="decode", n_layers=2))
    print(log.summary(), "\\n", log)

An *empty* ``opt`` tuple is the pipeline-off configuration: placement only,
bit-for-bit identical to the pre-pipeline path (the golden schedules pin
it).
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.passes.optimize import (  # noqa: F401
    DEFAULT_OPT, OPT_PASSES, BroadcastCoalescePass, MoveFusionPass,
    SelfMoveEliminationPass)
from repro_torch.passes.pipeline import (  # noqa: F401
    STAGES, Pass, Pipeline, Rewrite, RewriteLog)
from repro_torch.passes.placement import (  # noqa: F401
    LeasePlacePass, LegalizePass, PlacePass, ValidatePass)
from repro_torch.passes.rewrite import graphs_equal, rebuild  # noqa: F401
from repro_torch.passes.search import SearchPlacePass  # noqa: F401


def optimization_passes(names: Sequence[str] = DEFAULT_OPT, *,
                        pes_per_bank: int | None = None) -> tuple[Pass, ...]:
    """Instantiate optimization passes from registry names (order kept).

    ``pes_per_bank`` tells the hop-aware passes where bank boundaries lie
    on the placed graph; ``None`` treats the PE space as one bank (the
    single-bank scheduler's view).
    """
    out = []
    for name in names:
        factory = OPT_PASSES.get(name)
        if factory is None:
            raise ValueError(f"unknown optimization pass {name!r}; "
                             f"known: {sorted(OPT_PASSES)}")
        out.append(factory(pes_per_bank))
    return tuple(out)


def optimization_pipeline(names: Sequence[str] = DEFAULT_OPT, *,
                          pes_per_bank: int | None = None,
                          total_pes: int | None = None) -> Pipeline:
    """validate -> optimize -> legalize over an already-placed graph."""
    return Pipeline([
        ValidatePass(),
        *optimization_passes(names, pes_per_bank=pes_per_bank),
        LegalizePass(total_pes)])


def device_pipeline(geom, policy: str = "locality_first", *,
                    opt: Sequence[str] = ()) -> Pipeline:
    """The full pipeline for one device placement policy.

    ``opt`` names the optimization passes to run (``()`` = pipeline off —
    placement only, the pre-pipeline behavior).
    """
    return Pipeline([
        ValidatePass(), PlacePass(geom, policy),
        *optimization_passes(opt, pes_per_bank=geom.pes_per_bank),
        LegalizePass(geom.total_pes)])


def lease_pipeline(geom, banks, policy: str = "locality_first", *,
                   opt: Sequence[str] = ()) -> Pipeline:
    """The full pipeline for a bank-set lease (serving runtime placement)."""
    return Pipeline([
        ValidatePass(), LeasePlacePass(geom, banks, policy),
        *optimization_passes(opt, pes_per_bank=geom.pes_per_bank),
        LegalizePass(geom.total_pes)])


def search_pipeline(geom, mode, *, config=None, opt: Sequence[str] = (),
                    oracle=None) -> Pipeline:
    """The full pipeline with the cost-driven search as its place stage.

    ``mode`` (an :class:`~repro_torch.core.pluto.Interconnect`) is what the
    greedy place stage never needed: the search's oracle prices real
    schedules, so the place decision becomes interconnect-aware.  The
    searched placement is never worse than the best greedy policy's (the
    search seeds from all of them and verifies with the engine).
    """
    return Pipeline([
        ValidatePass(), SearchPlacePass(mode, geom, config=config,
                                        oracle=oracle),
        *optimization_passes(opt, pes_per_bank=geom.pes_per_bank),
        LegalizePass(geom.total_pes)])


def lease_search_pipeline(geom, banks, mode, *, config=None,
                          opt: Sequence[str] = (),
                          oracle=None) -> Pipeline:
    """:func:`search_pipeline` over a leased bank subset (serving path)."""
    return Pipeline([
        ValidatePass(), SearchPlacePass(mode, geom, banks=banks,
                                        config=config, oracle=oracle),
        *optimization_passes(opt, pes_per_bank=geom.pes_per_bank),
        LegalizePass(geom.total_pes)])
