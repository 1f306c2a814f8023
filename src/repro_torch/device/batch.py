"""Batch scheduling of many sweep configurations in one call (PyTorch port
of ``repro/device/batch.py``).

A device-scale study is a grid: (app graph x geometry x interconnect x
placement policy x scaling).  Running it as a per-config loop rebuilds and
re-places the same graphs over and over; :class:`BatchRunner` schedules the
whole grid in one call and deduplicates everything that is shared:

* **structural graphs** — built once per (app, problem size) via the
  ``lru_cache`` in :mod:`repro_torch.core.taskgraph`;
* **placed graphs** — composed/placed once per (app, geometry, policy,
  scaling) cell via :func:`repro_torch.device.partition.partitioned_struct`;
  both interconnects of a cell share the same placed structure, its
  successor CSR and its level assignment (memoized on the graph);
* **optimized graphs** — when a config names optimization passes
  (``SweepConfig.opt``), the pass-pipeline output is memoized per (cell,
  pipeline) via :func:`repro_torch.device.partition.optimized_struct`, whose
  cache key carries the pipeline's pass identity (its fingerprint is
  recorded alongside), so every mode of a cell — and every other config
  sharing the pipeline — reuses one optimized artifact;
* **durations** — materialized per mode as one vectorized lookup;
* **resource models** — one :class:`~repro_torch.device.resources.DeviceModel`
  (and its memoized cross-bank plan prices) per (mode, geometry).

Every schedule runs on the runner's ``device`` — ``cuda`` unless the caller
asks for the CPU (asking for ``cuda`` without a card raises at
construction); the graphs and the models stay host data either way, and
the results are bit-for-bit those of the preserved legacy scheduler
(:mod:`repro_torch.device.reference`).  The placement-search layers
(:meth:`BatchRunner.placement_oracle`, :meth:`BatchRunner.search_placement`)
price their candidates on the same device.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Iterable, Sequence

import torch

from repro_torch.core.pluto import Interconnect
from repro_torch.device import partition, resolve
from repro_torch.device import scheduler as dev_sched
from repro_torch.device.geometry import DeviceGeometry
from repro_torch.device.resources import DeviceModel
from repro_torch.device.scheduler import DeviceScheduleResult


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """One cell of a sweep grid (hashable; ``kw`` holds app kwargs).

    ``opt`` names the pass-pipeline optimization stage for this cell
    (:data:`repro_torch.passes.OPT_PASSES` keys, order significant); the empty
    tuple is the pipeline-off configuration, bit-for-bit identical to the
    pre-pipeline path.
    """

    app: str
    mode: Interconnect
    geometry: DeviceGeometry
    policy: str = "locality_first"
    scaling: str = "strong"
    kw: tuple = ()
    opt: tuple = ()

    @classmethod
    def make(cls, app: str, mode: Interconnect, geometry: DeviceGeometry,
             policy: str = "locality_first", scaling: str = "strong",
             opt: Sequence[str] = (), **kw) -> "SweepConfig":
        return cls(app, mode, geometry, policy, scaling,
                   tuple(sorted(kw.items())), tuple(opt))

    @property
    def kwargs(self) -> dict:
        return dict(self.kw)


class BatchRunner:
    """Schedules N (graph x geometry x interconnect x policy) configs.

    An optional :class:`~repro_torch.obs.metrics.MetricsRegistry`
    aggregates the whole grid as it runs — cells scheduled,
    per-interconnect makespan distributions, resource-model cache misses —
    so a sweep script gets its grid-level numbers from the same registry a
    serving run populates.

    Every schedule's engine session runs on ``device``.
    """

    def __init__(self, metrics=None,
                 device: str | torch.device = "cuda") -> None:
        self._models: dict = {}
        self.metrics = metrics
        self.device = resolve(device)

    def _model(self, mode: Interconnect, geom: DeviceGeometry) -> DeviceModel:
        key = (mode, geom)
        m = self._models.get(key)
        if m is None:
            m = self._models[key] = DeviceModel(mode, geom)
            if self.metrics is not None:
                self.metrics.counter("model_cache_misses").inc()
        return m

    def run_one(self, cfg: SweepConfig) -> DeviceScheduleResult:
        # pass the cached structural graph; schedule() materializes the
        # durations for cfg.mode itself (exactly once)
        if cfg.opt:
            g = partition.optimized_struct(cfg.app, cfg.geometry,
                                           policy=cfg.policy,
                                           scaling=cfg.scaling, opt=cfg.opt,
                                           **cfg.kwargs)
        else:
            g = partition.partitioned_struct(cfg.app, cfg.geometry,
                                             policy=cfg.policy,
                                             scaling=cfg.scaling,
                                             **cfg.kwargs)
        r = dev_sched.schedule(g, cfg.mode, cfg.geometry,
                               model=self._model(cfg.mode, cfg.geometry),
                               device=self.device)
        if self.metrics is not None:
            self.metrics.counter("cells_scheduled").inc()
            self.metrics.histogram(
                f"makespan_ns/{cfg.mode.value}").observe(r.makespan_ns)
        return r

    def run(self, configs: Iterable[SweepConfig],
            callback: Callable[[SweepConfig, DeviceScheduleResult], None]
            | None = None) -> list[DeviceScheduleResult]:
        """Schedule every config; results align with the input order."""
        out = []
        for cfg in configs:
            r = self.run_one(cfg)
            if callback is not None:
                callback(cfg, r)
            out.append(r)
        return out

    # --- placement-search layers (parallel + persistent) ------------------------

    def placement_oracle(self, cfg: SweepConfig, *, cache=None,
                         n_workers: int | None = None, profile=None):
        """A :class:`repro_torch.search.PlacementOracle` over ``cfg``'s cell,
        on this runner's device.

        Layered on this runner's dedup caches: the structural graph comes
        from the ``taskgraph`` ``lru_cache`` and the resource model from
        :meth:`_model`, so an oracle and an ordinary sweep of the same
        (mode, geometry) share one :class:`DeviceModel` and its memoized
        cross-bank plan prices.  ``cache`` (an
        :class:`repro_torch.search.OracleCache` or a path) adds the
        persistent layer; ``n_workers`` the (spawned) process-pool one.
        """
        from repro_torch import search
        from repro_torch.core import taskgraph
        struct = taskgraph.structural(
            cfg.app, n_pes=cfg.geometry.total_pes, **cfg.kwargs)
        if cache is not None and not hasattr(cache, "get"):
            cache = search.OracleCache(cache)
        return search.PlacementOracle(
            struct, cfg.mode, cfg.geometry, cache=cache,
            model=self._model(cfg.mode, cfg.geometry),
            n_workers=n_workers, profile=profile, device=self.device)

    def search_placement(self, cfg: SweepConfig, *, config=None,
                         cache=None, n_workers: int | None = None,
                         profile=None):
        """Run the cost-driven placement search on one sweep cell.

        Returns the :class:`repro_torch.search.SearchResult`; the oracle
        (and its worker pool, if any) is torn down before returning.
        """
        from repro_torch import search
        from repro_torch.core import taskgraph
        oracle = self.placement_oracle(cfg, cache=cache,
                                       n_workers=n_workers, profile=profile)
        struct = taskgraph.structural(
            cfg.app, n_pes=cfg.geometry.total_pes, **cfg.kwargs)
        try:
            return search.search_pe_map(struct, cfg.mode, cfg.geometry,
                                        config=config, oracle=oracle)
        finally:
            oracle.close()


def run_grid(configs: Sequence[SweepConfig], *,
             device: str | torch.device = "cuda"
             ) -> list[DeviceScheduleResult]:
    """One-shot convenience wrapper around :class:`BatchRunner`."""
    return BatchRunner(device=device).run(configs)


def clear_caches() -> None:
    """Drop every cross-config cache (for cold-start benchmarking).

    Also tears down the placement-search layers: every live oracle's
    in-memory memo and surrogate tables and every
    :class:`repro_torch.search.OracleCache`'s loaded state.  On-disk cache
    files survive — they are the *persistent* layer; the next access
    re-reads them cold.
    """
    from repro_torch.core import taskgraph

    partition._partitioned_struct.cache_clear()
    partition._optimized_struct.cache_clear()
    for fn, _sig in taskgraph._STRUCTS.values():
        fn.cache_clear()
    search = sys.modules.get("repro_torch.search")
    if search is not None:          # only if the search layer was ever used
        search.clear_caches()
