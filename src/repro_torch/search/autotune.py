"""Per-workload-family pass-pipeline autotuner (PyTorch port of
``repro/search/autotune.py``).

Different graph families want different place stages: op-dominated graphs
are placement-insensitive (any greedy policy ties, so paying for a search
is waste), while move-heavy graphs reward the full cost-driven search.
:class:`Autotuner` decides *per graph fingerprint* — the family key
:func:`repro_torch.core.ir.graph_fingerprint` gives every structurally
identical workload — by running one search (which embeds every greedy
policy as its seeds) and comparing the engine-verified outcomes.  The
choice is cached in the same persistent :class:`~repro_torch.search.cache
.OracleCache` the oracle uses, so a family is tuned once per cache
lifetime; later runs build the chosen pipeline immediately.

The decision rule is conservative: the search pipeline is chosen only
when it improves on the best greedy policy by at least ``min_gain``
(fractional); otherwise the winning greedy policy's ordinary placement
pipeline is kept — it is cheaper to run and exactly as good.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import ir
from repro_torch.core.ir import TaskGraph
from repro_torch.core.pluto import Interconnect
from repro_torch.device.geometry import DeviceGeometry
from repro_torch.search.cache import OracleCache
from repro_torch.search.oracle import geometry_key
from repro_torch.search.place import SearchConfig, search_pe_map


@dataclasses.dataclass(frozen=True)
class TunedChoice:
    """One family's cached pipeline decision."""

    pipeline: str                # "search" | "greedy"
    policy: str                  # winning greedy policy (search seed)
    makespan_ns: float           # engine-verified makespan of the choice
    greedy_makespan_ns: float    # best greedy baseline it was judged against
    digest: str                  # winning placement digest
    from_cache: bool = False

    def as_value(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("from_cache")
        return d


class Autotuner:
    """Chooses and caches the place-stage pipeline per graph family."""

    def __init__(self, mode: Interconnect, geom: DeviceGeometry, *,
                 cache: OracleCache | None = None,
                 config: SearchConfig | None = None,
                 min_gain: float = 1e-4):
        self.mode, self.geom = mode, geom
        self.cache = cache
        self.config = config or SearchConfig()
        self.min_gain = min_gain

    def _key(self, struct: TaskGraph) -> str:
        return (f"autotune/{ir.graph_fingerprint(struct)}/"
                f"{geometry_key(self.geom)}/{self.mode.value}/"
                f"{self.config.describe()}")

    def choose(self, struct: TaskGraph) -> TunedChoice:
        """The tuned pipeline choice for ``struct``'s family (cached)."""
        key = self._key(struct)
        if self.cache is not None:
            v = self.cache.get(key)
            if isinstance(v, dict):
                try:
                    return TunedChoice(from_cache=True, **v)
                except TypeError:
                    pass              # stale/foreign schema: retune
        # share the persistent cache with the oracle: a retune of a family
        # whose candidates were ever evaluated is engine-eval free
        oracle = None
        if self.cache is not None:
            from repro_torch.search.oracle import PlacementOracle
            oracle = PlacementOracle(struct, self.mode, self.geom,
                                     cache=self.cache,
                                     n_workers=self.config.n_workers,
                                     device=self.config.device)
        try:
            res = search_pe_map(struct, self.mode, self.geom,
                                config=self.config, oracle=oracle)
        finally:
            if oracle is not None:
                oracle.close()
        if res.improvement >= self.min_gain:
            choice = TunedChoice("search", res.incumbent_policy,
                                 res.makespan_ns,
                                 res.incumbent_makespan_ns, res.digest)
        else:
            choice = TunedChoice("greedy", res.incumbent_policy,
                                 res.incumbent_makespan_ns,
                                 res.incumbent_makespan_ns, res.digest)
        if self.cache is not None:
            self.cache.put(key, choice.as_value())
        return choice

    def pipeline(self, struct: TaskGraph, *, opt=()):
        """A ready-to-run pass pipeline implementing the tuned choice."""
        from repro_torch import passes as passlib
        choice = self.choose(struct)
        if choice.pipeline == "search":
            return passlib.search_pipeline(self.geom, self.mode,
                                           config=self.config, opt=opt)
        return passlib.device_pipeline(self.geom, choice.policy, opt=opt)
