"""Single-bank PIM scheduling: a thin shim over the resource-token engine
(PyTorch port of ``repro/core/scheduler.py``).

Models a DRAM bank as a set of subarray processing elements (PEs) plus an
interconnect, and schedules a dependency graph of compute ops and row moves.
The *only* difference between the two interconnect modes is resource
semantics — exactly the paper's point:

* ``LISA``: a move from subarray s to subarray d occupies the local bitlines
  of EVERY subarray in [min(s,d), max(s,d)] for its whole duration (RBM links
  their bitlines, Sec II-B2).  Latency grows linearly with |d - s|.
  Computation on those PEs STALLS.

* ``SHARED_PIM``: a move occupies only the BK-bus plus one transmit shared
  row at the source and one receive shared row at the destination.  Latency
  is distance-independent (52.75 ns per 8KB row).  The PEs keep computing —
  the paper's STALL -> NOP transformation.  Per-subarray shared-row tokens
  (2 per subarray: 1 tx + 1 rx) bound the concurrency, and broadcasts reach
  up to 4 destinations in one bus transaction.

Those semantics live in :class:`repro_torch.core.engine.BankModel` as
declarative resource-token claims; this module only keeps the public
single-bank API — the :class:`Task` type, the :class:`ScheduleResult`
report, and the ``schedule``/``compare``/``improvement`` entry points.
``schedule`` accepts either an iterable of :class:`Task` or a pre-built
:class:`~repro_torch.core.ir.TaskGraph`, and runs on ``device`` — ``cuda``
unless the caller asks for the CPU (asking for ``cuda`` without a card
raises).  Results are bit-for-bit identical to the pre-engine
implementation (kept in :mod:`repro_torch.core.reference`; the golden
schedules pin both).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Union

import torch

from repro_torch.core import engine, ir, pluto
from repro_torch.core.pluto import Interconnect


@dataclasses.dataclass
class Task:
    """One node of the dataflow graph.

    kind:
      "op":    compute on PE ``pe`` for ``duration`` ns
      "move":  transfer ``rows`` 8KB rows from ``src`` to ``dst`` (dst may be a
               tuple for Shared-PIM broadcast)
    """

    uid: int
    kind: str
    deps: tuple[int, ...] = ()
    pe: int | None = None
    src: int | None = None
    dst: int | tuple[int, ...] | None = None
    duration: float = 0.0        # ops only; moves derive duration from mode
    rows: int = 1                # moves: number of 8KB row hand-offs
    tag: str = ""


@dataclasses.dataclass
class ScheduleResult:
    mode: Interconnect
    makespan_ns: float
    op_busy_ns: float            # total PE-ns spent computing
    move_busy_ns: float          # total interconnect-ns spent moving
    stall_ns: float              # PE-ns blocked by moves (LISA only)
    n_ops: int
    n_moves: int
    n_rows_moved: int
    finish_times: dict[int, float]

    @property
    def transfer_energy_j(self) -> float:
        per_row = (pluto.E_MOVE_LISA if self.mode is Interconnect.LISA
                   else pluto.E_MOVE_BUS)
        return self.n_rows_moved * per_row

    @property
    def compute_energy_j(self) -> float:
        return self.n_ops * pluto.E_LUT_PASS


def _dsts(t: Task) -> tuple[int, ...]:
    return t.dst if isinstance(t.dst, tuple) else (t.dst,)


#: legacy alias — the canonical model lives in :mod:`repro_torch.core.engine`
_move_latency = engine.move_latency

Graphish = Union[Iterable[Task], ir.TaskGraph]


def as_graph(tasks: Graphish) -> ir.TaskGraph:
    """Coerce a legacy task list (or an IR graph, unchanged) to the IR."""
    if isinstance(tasks, ir.TaskGraph):
        return tasks
    return ir.from_tasks(tasks)


def schedule(tasks_in: Graphish, mode: Interconnect,
             n_pes: int = 16, *,
             device: str | torch.device = "cuda") -> ScheduleResult:
    """List-schedule a task graph on one bank under the given interconnect.

    Structural graphs with symbolic op classes are materialized for ``mode``
    here (idempotent for already-materialized graphs), so passing
    ``taskgraph.structural(...)`` directly cannot silently schedule
    zero-duration ops.
    """
    g = ir.materialize(as_graph(tasks_in), mode)
    stats = engine.run(g, engine.BankModel(mode, n_pes), device=device)
    return ScheduleResult(
        mode, stats.makespan_ns, stats.op_busy_ns, stats.move_busy_ns,
        stats.stall_ns, stats.n_ops, stats.n_moves, stats.n_rows_moved,
        stats.finish_times)


def compare(tasks: Graphish, n_pes: int = 16, *,
            device: str | torch.device = "cuda"
            ) -> dict[str, ScheduleResult]:
    """Schedule the same graph under both interconnects."""
    g = as_graph(tasks)
    return {
        "lisa": schedule(g, Interconnect.LISA, n_pes, device=device),
        "shared_pim": schedule(g, Interconnect.SHARED_PIM, n_pes,
                               device=device),
    }


def improvement(results: dict[str, ScheduleResult]) -> float:
    """Fractional makespan improvement of Shared-PIM over LISA.

    An empty task graph has zero makespan under both interconnects; report
    zero improvement rather than dividing by zero.
    """
    lisa = results["lisa"].makespan_ns
    sp = results["shared_pim"].makespan_ns
    if lisa == 0.0:
        return 0.0
    return 1.0 - sp / lisa
