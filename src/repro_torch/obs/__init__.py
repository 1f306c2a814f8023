"""Opt-in observability: schedule tracing, metrics, and self-profiling
(PyTorch port of ``repro/obs/``).

Three small, composable pieces, all strictly opt-in (a session with none
of them attached runs the exact pre-observability code path — the golden
schedules stay bit-for-bit):

``trace``    :class:`Recorder` — the engine appends raw claim/refresh/job
             events while it runs; export to Chrome trace-event JSON
             (one track per PE / bus / shared row / refresh unit, plus
             job, lease, and windowed power-counter tracks) loadable at
             https://ui.perfetto.dev, with graph fingerprints,
             interconnect mode, and rewrite logs as reproducible
             provenance
``metrics``  :class:`MetricsRegistry` — counters / gauges / histograms
             for the serving and batch layers (queue depth, lease
             occupancy, latency, SLO attainment, per-resource utilization,
             per-job/per-tenant :func:`energy_attribution`)
``profile``  :class:`EngineProfile` — wall-clocks the event loop itself:
             events/sec, heap ops, token free-time probes, admit-side
             energy-metering cost

Quickstart (trace one sweep cell, view at ui.perfetto.dev)::

    from repro_torch import obs
    from repro_torch.core.pluto import Interconnect
    from repro_torch.device import DeviceGeometry, SweepConfig

    cfg = SweepConfig.make("mm", Interconnect.SHARED_PIM,
                           DeviceGeometry(channels=1, banks_per_channel=4),
                           n=24)
    obs.record_sweep(cfg).dump("mm_sp.trace.json")   # on the card

``record_sweep(cfg, device="cpu")`` records on the host.  ``python -m
repro_torch.obs [--device cpu]`` emits a ready-made Shared-PIM vs LISA trace
pair (see :mod:`repro_torch.obs.viewer`).
"""

from repro_torch.obs.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, energy_attribution,
    slo_attainment, utilization)
from repro_torch.obs.profile import (  # noqa: F401
    AdmitSample, AdvanceSample, EngineProfile)
from repro_torch.obs.trace import (  # noqa: F401
    Recorder, graph_fingerprint, record_sweep, rewrite_log_metadata)
