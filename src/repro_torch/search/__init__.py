"""Cost-driven placement search on the engine oracle (PyTorch port of
``repro/search/``).

This package closes the ROADMAP's search-based-placement loop: instead of
trusting one greedy heuristic, the place stage can *search* the space of
virtual->global PE maps with the discrete-event engine as its makespan
oracle — the compiler-directed data placement the PIM-adoption literature
names as the adoption gap.  The one invariant everything here preserves:

    **the oracle is the engine; the surrogate only prunes, never decides.**

Layout:

* :mod:`repro_torch.search.oracle`    — :class:`PlacementOracle`: memoized,
  persistently cached, optionally process-pool-parallel engine evals;
* :mod:`repro_torch.search.surrogate` — :class:`LowerBoundModel`: the admissible
  makespan lower bound used only to discard can't-win candidates;
* :mod:`repro_torch.search.cache`     — :class:`OracleCache`: append-only JSONL
  store keyed (fingerprint, geometry, interconnect, placement digest),
  tolerant of corrupt/truncated entries;
* :mod:`repro_torch.search.place`     — :func:`search_pe_map`: seeded beam
  search + simulated-annealing refinement, deterministic by seed at any
  worker count;
* :mod:`repro_torch.search.autotune`  — :class:`Autotuner`: per-graph-family
  pipeline choice (search vs winning greedy policy), cached by
  fingerprint.

Pipeline integration lives in :class:`repro_torch.passes.SearchPlacePass`
(``validate -> search-place -> optimize -> legalize``); the serving
runtime opts in with ``ServingRuntime(..., placement="search")``.

The engine evaluations run on ``SearchConfig.device`` / the oracle's
``device`` (``cuda`` unless the caller asks for the CPU; there is no
fallback); the worker pool is spawned, never forked.
"""

from __future__ import annotations

from repro_torch.search.autotune import Autotuner, TunedChoice  # noqa: F401
from repro_torch.search.cache import OracleCache  # noqa: F401
from repro_torch.search.oracle import (  # noqa: F401
    SCALAR_ORACLE_CUTOVER, OracleStats, PlacementOracle, clear_caches,
    geometry_key, placement_digest, resolve_workers)
from repro_torch.search.place import (  # noqa: F401
    SearchConfig, SearchResult, search_pe_map)
from repro_torch.search.surrogate import LowerBoundModel  # noqa: F401
