"""Device-scale PIM scheduling: a thin shim over the resource-token engine
(PyTorch port of ``repro/device/scheduler.py``).

Extends the single-bank model to a full
:class:`~repro_torch.device.geometry.DeviceGeometry`: tasks address **global PE
ids**, intra-bank moves keep the exact single-bank resource semantics (LISA
span stalls vs Shared-PIM BK-bus + shared-row tokens), and moves whose
endpoints live in different banks are routed through the cheapest legal path
of the hierarchy (bank-group bus, then channel I/O) with contention modeled
on every shared resource along the route.

All of those semantics are expressed as declarative resource-token claims by
:class:`repro_torch.device.resources.DeviceModel` and executed by
:func:`repro_torch.core.engine.run`; this module only configures the model and
wraps the engine's raw stats into :class:`DeviceScheduleResult`.  Like the
single-bank shim, ``schedule`` accepts a legacy task iterable or a pre-built
:class:`~repro_torch.core.ir.TaskGraph`, and runs on ``device`` — ``cuda``
unless the caller asks for the CPU (asking for ``cuda`` without a card
raises).

**Single-bank equivalence**: with ``DeviceGeometry(channels=1,
banks_per_channel=1)`` every task is intra-bank and the compiled claim
segments coincide with :class:`~repro_torch.core.engine.BankModel`'s —
makespan, busy/stall times, counts, energy and per-task finish times reproduce
``core.scheduler.schedule`` bit-for-bit (the golden schedules pin both).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import engine, ir, pluto
from repro_torch.core.pluto import Interconnect
from repro_torch.core.scheduler import Graphish, as_graph, improvement
from repro_torch.device.geometry import DeviceGeometry, SINGLE_BANK
from repro_torch.device.resources import DeviceModel


@dataclasses.dataclass
class DeviceScheduleResult:
    """Schedule outcome for one interconnect mode on one device geometry.

    The first block of fields mirrors ``core.scheduler.ScheduleResult`` (and
    is bit-identical to it on a single-bank geometry); the second block adds
    the device-level breakdown.
    """

    mode: Interconnect
    geometry: DeviceGeometry
    makespan_ns: float
    op_busy_ns: float
    move_busy_ns: float
    stall_ns: float
    n_ops: int
    n_moves: int
    n_rows_moved: int
    finish_times: dict[int, float]
    # --- device-level extras ---
    transfer_energy_j: float
    n_cross_moves: int                 # moves with at least one off-bank dest
    rows_by_route: dict[str, int]      # rows delivered per route class
    bus_busy_ns: dict[str, float]      # occupancy per shared-bus class

    @property
    def cross_rows(self) -> int:
        return sum(v for k, v in self.rows_by_route.items() if k != "intra")

    @property
    def compute_energy_j(self) -> float:
        return self.n_ops * pluto.E_LUT_PASS


def schedule(tasks_in: Graphish, mode: Interconnect,
             geometry: DeviceGeometry = SINGLE_BANK, *,
             model: DeviceModel | None = None,
             device: str | torch.device = "cuda") -> DeviceScheduleResult:
    """List-schedule a global-PE task graph on the whole device.

    ``model`` lets callers reuse one :class:`DeviceModel` (and its memoized
    cross-bank plan prices) across many schedules of the same (mode,
    geometry) — the batch runner's fast path.  It must match ``mode`` and
    ``geometry``.  Structural graphs with symbolic op classes are
    materialized for ``mode`` here (idempotent when already materialized).
    ``device`` is where the engine session's state lives.
    """
    if model is None:
        model = DeviceModel(mode, geometry)
    elif model.mode is not mode or model.geom != geometry:
        raise ValueError(
            f"model is for ({model.mode}, {model.geom.describe()}), "
            f"not ({mode}, {geometry.describe()})")
    g = ir.materialize(as_graph(tasks_in), mode)
    stats = engine.run(g, model, device=device)
    # one flat per-row delivery charge across all routes (single multiply so
    # a 1-bank device reproduces ScheduleResult.transfer_energy_j bit-for-bit)
    e_move_row = (pluto.E_MOVE_LISA if mode is Interconnect.LISA
                  else pluto.E_MOVE_BUS)
    energy = stats.energy_j \
        + sum(stats.rows_by_route.values()) * e_move_row
    return DeviceScheduleResult(
        mode, geometry, stats.makespan_ns, stats.op_busy_ns,
        stats.move_busy_ns, stats.stall_ns, stats.n_ops, stats.n_moves,
        stats.n_rows_moved, stats.finish_times, energy, stats.n_cross_moves,
        stats.rows_by_route, stats.bus_busy_ns)


def compare(tasks: Graphish, geometry: DeviceGeometry = SINGLE_BANK, *,
            device: str | torch.device = "cuda"
            ) -> dict[str, DeviceScheduleResult]:
    """Schedule the same device graph under both interconnects."""
    g = as_graph(tasks)
    return {
        "lisa": schedule(g, Interconnect.LISA, geometry, device=device),
        "shared_pim": schedule(g, Interconnect.SHARED_PIM, geometry,
                               device=device),
    }


# the core helper only reads makespan_ns from the two results, so it serves
# DeviceScheduleResult dicts unchanged (re-exported here and in the package)
__all__ = ["DeviceScheduleResult", "schedule", "compare", "improvement"]
