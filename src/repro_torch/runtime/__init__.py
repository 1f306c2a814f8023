"""Online serving runtime: streaming multi-tenant PIM simulation (PyTorch
port of ``repro/runtime/``).

Layers the ROADMAP's serving goal on top of the resource-token engine:

``trace``      deterministic open-loop (Poisson) / closed-loop job streams
``allocator``  bank-set leasing with FIFO / SJF / priority admission
``serve``      ServingRuntime: traces -> leases -> one live EngineSession

Quickstart::

    from repro_torch.core.pluto import Interconnect
    from repro_torch.core.engine import RefreshSpec
    from repro_torch.device import DeviceGeometry
    from repro_torch import runtime

    geom = DeviceGeometry(channels=1, banks_per_channel=8)
    tenants = [runtime.TenantSpec.make("mm", "mm", n=40, banks=2,
                                       rate_jps=2000.0),
               runtime.TenantSpec.make("bfs", "bfs", n_nodes=120,
                                       priority=1)]
    trace = runtime.open_loop_trace(tenants, jobs_per_tenant=20, seed=0)
    rt = runtime.ServingRuntime(Interconnect.SHARED_PIM, geom,
                                admission="priority",
                                refresh=RefreshSpec())   # on the card
    print(runtime.summarize(rt.run(trace))["latency_ns"])

``ServingRuntime(..., device="cpu")`` serves on the host; the results are
the same bit for bit.
"""

from repro_torch.runtime.allocator import (  # noqa: F401
    ADMISSION_POLICIES, BankAllocator, ContinuousAllocator, Lease, Residency,
    StepGrant)
from repro_torch.runtime.serve import (  # noqa: F401
    ContinuousRuntime, JobResult, ServingRuntime, SessionResult, summarize)
from repro_torch.runtime.trace import (  # noqa: F401
    TRACE_APPS, ClosedLoopSource, JobRequest, MultiTurnSource,
    SessionRequest, SessionSpec, TenantSpec, known_apps, open_loop_trace,
    session_trace)
