"""Per-op-class and per-hop energy tables for the resource models.
(PyTorch port of ``repro/core/energy.py``: plain Python floats, the same
expressions in the same order, no tensors.)

Energy here is **derived accounting, never a schedule input**: the engine
prices every task's joules at compile time from the same copy-model
coefficients that price its nanoseconds, and accumulates them at admit
time — the event loops never read an energy value, so attaching the
metering cannot move a single scheduled float (the 114 golden schedules
and the vector == scalar differential tests pin this).

Two layers live here:

* :func:`move_energy` — the energy twin of
  :func:`repro_torch.core.engine.move_latency`: contention-free joules of one
  intra-bank move, memoized per (mechanism, distance / fan-out) exactly
  like the latency coefficients.  LISA is distance-priced (every RBM hop
  links two more sense-amplifier rows); Shared-PIM is distance-free and
  amortizes the source activation across broadcast destinations.

* :class:`EnergyTable` — the per-op-class / per-hop price list a
  :class:`~repro_torch.core.engine.ResourceModel` exposes via
  ``energy_table()``.  All entries derive from the paper-calibrated
  constants in :mod:`repro_torch.core.timing` (Table II: 0.17 uJ LISA vs
  0.14 uJ Shared-PIM per 8KB row) and the pLUTo compute baseline —
  ``benchmarks/paper_tables.py`` cross-checks them against the published
  numbers so they stay pinned to the source rather than free parameters.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import copy_models
from repro_torch.core import timing as T
from repro_torch.core.pluto import E_LUT_PASS, Interconnect

#: bits per 8KB DRAM row — the denominator of every pJ/bit entry
ROW_BITS = T.DDR3_1600.row_bytes * 8

#: one applied refresh window (tRFC) on one bank.  A refresh command
#: internally activates and restores rows back-to-back for the whole tRFC
#: window; at tRC cadence that is ceil(tRFC / tRC) = ceil(350 / 48.75) = 8
#: row-activate equivalents.
E_REFRESH_WINDOW = 8 * T.E_ACT_ROW


# --- cached per-row transfer energies (twin of the latency memos) ---------------

_LISA_ROW_J: dict[int, float] = {}
_SP_BCAST_J: dict[int, float] = {}
_SP_ROW_J: float | None = None


def _lisa_row_j(dist: int) -> float:
    e = _LISA_ROW_J.get(dist)
    if e is None:
        e = _LISA_ROW_J[dist] = copy_models.lisa_copy(distance=dist).energy_j
    return e


def _sp_row_j() -> float:
    global _SP_ROW_J
    if _SP_ROW_J is None:
        _SP_ROW_J = copy_models.sharedpim_copy().energy_j
    return _SP_ROW_J


def _sp_bcast_j(fanout: int) -> float:
    e = _SP_BCAST_J.get(fanout)
    if e is None:
        e = _SP_BCAST_J[fanout] = copy_models.sharedpim_broadcast(
            dests=tuple(range(1, fanout + 1))).energy_j
    return e


def move_energy(mode: Interconnect, src: int, dsts, rows: int) -> float:
    """Contention-free energy of one intra-bank move (latency's twin).

    Mirrors :func:`repro_torch.core.engine.move_latency` case for case — LISA
    pays one distance-priced copy per destination, Shared-PIM pays one
    distance-free bus transaction per <=4-destination broadcast group —
    so every nanosecond the schedule prices has a matching joule.
    """
    if mode is Interconnect.LISA:
        total = 0.0
        for d in dsts:
            dist = abs(d - src)
            if dist < 1:
                dist = 1
            total += rows * _lisa_row_j(dist)
        return total
    if len(dsts) == 1:
        return rows * _sp_row_j()
    e = 0.0
    remaining = list(dsts)
    while remaining:
        grp = remaining[:4]
        remaining = remaining[4:]
        e += rows * _sp_bcast_j(len(grp))
    return e


# --- the price list -------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EnergyTable:
    """Per-op-class and per-hop energy prices of one resource model.

    Row-granular entries are J per 8KB row; :meth:`per_bit_pj` exposes the
    same table in pJ/bit (and pJ/op for compute) for calibration tables
    and docs.  ``d2d_row_j`` prices the off-package link as one extra
    channel-I/O crossing, consistent with the fleet tier's transit
    latency model.
    """

    op_j: float = E_LUT_PASS                 # one PE op (pLUTo LUT sweep)
    sp_row_j: float = 0.0                    # SP bus transaction, 1 row, 1 dst
    lisa_row_j: float = 0.0                  # LISA copy, 1 row, distance 1
    tx_row_j: float = T.E_ACT_ROW            # stage into a tx shared row
    rx_row_j: float = T.E_ACT_ROW            # latch from an rx shared row
    bk_bus_row_j: float = \
        T.DEFAULT_GEOMETRY.bus_segments * T.E_BKSA_SEGMENT_ROW
    group_row_j: float = \
        T.E_GRB_PER_BYTE * T.DDR3_1600.row_bytes
    channel_row_j: float = \
        T.E_CHANNEL_PER_BYTE * 2 * T.DDR3_1600.row_bytes
    d2d_row_j: float = \
        T.E_CHANNEL_PER_BYTE * 2 * T.DDR3_1600.row_bytes
    refresh_window_j: float = E_REFRESH_WINDOW

    def per_bit_pj(self) -> dict[str, float]:
        """The per-hop table in pJ/bit (compute in pJ/op, refresh pJ/window)."""
        to_pj_bit = 1e12 / ROW_BITS
        return {
            "pe_op_pj": self.op_j * 1e12,
            "bk_bus_pj_bit": self.bk_bus_row_j * to_pj_bit,
            "tx_row_pj_bit": self.tx_row_j * to_pj_bit,
            "rx_row_pj_bit": self.rx_row_j * to_pj_bit,
            "group_bus_pj_bit": self.group_row_j * to_pj_bit,
            "channel_bus_pj_bit": self.channel_row_j * to_pj_bit,
            "d2d_link_pj_bit": self.d2d_row_j * to_pj_bit,
            "refresh_window_pj": self.refresh_window_j * 1e12,
        }


#: the one concrete price list in this repo — both BankModel and
#: DeviceModel derive their joules from the same Table II constants
DEFAULT_TABLE = EnergyTable(sp_row_j=copy_models.sharedpim_copy().energy_j,
                            lisa_row_j=copy_models.lisa_copy(
                                distance=1).energy_j)
