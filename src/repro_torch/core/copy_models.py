"""Inter-subarray copy mechanisms: memcpy, RowClone, LISA, Shared-PIM.
(PyTorch port of ``repro/core/copy_models.py``: plain Python floats, the same
expressions in the same order, no tensors.)

Each mechanism is modeled as a *command sequence* over the timing constants in
:mod:`repro_torch.core.timing`, yielding (a) total latency, (b) energy, (c) the Fig-6
style command timeline, and (d) **concurrency semantics** — which resources the
copy occupies while in flight.  The concurrency semantics are what distinguish
Shared-PIM from every baseline and are consumed by :mod:`repro_torch.core.scheduler`:

========== ==================================================================
mechanism  resources occupied during the copy
========== ==================================================================
memcpy     the memory channel + both subarrays (row buffers pinned)
RC-InterSA the bank global row buffer + both subarrays
LISA       *every* subarray in [src, dst] (RBM links their bitlines)
Shared-PIM the BK-bus + the two shared rows ONLY — local sense amps stay free
========== ==================================================================

Latency cross-check against the paper (DDR3-1600, 8KB row, Table II):

>>> from repro_torch.core import timing, copy_models
>>> copy_models.memcpy_copy().latency_ns
1366.25
>>> copy_models.rc_intersa_copy().latency_ns
1363.75
>>> copy_models.lisa_copy(distance=1).latency_ns
260.5
>>> copy_models.sharedpim_copy().latency_ns
52.75
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core import timing as T


@dataclasses.dataclass(frozen=True)
class Command:
    """One DRAM command in a Fig-6 style timeline."""

    name: str
    start_ns: float
    duration_ns: float

    @property
    def end_ns(self) -> float:
        return self.start_ns + self.duration_ns


@dataclasses.dataclass(frozen=True)
class CopyResult:
    mechanism: str
    latency_ns: float
    energy_j: float
    timeline: tuple[Command, ...]
    #: subarray indices whose local sense amps are BLOCKED while the copy runs
    stalled_subarrays: tuple[int, ...]
    #: True if the copy occupies the BK-bus (Shared-PIM) for its duration
    occupies_bus: bool
    #: True if the copy occupies the bank global row buffer / channel
    occupies_channel: bool


def _span(src: int, dst: int) -> tuple[int, ...]:
    lo, hi = min(src, dst), max(src, dst)
    return tuple(range(lo, hi + 1))


# --- Published-total calibration residues (documented in timing.py header) ------
# Sub-cycle SPICE residue the command-level model cannot derive; kept explicit.
_CALIB_MEMCPY_NS = 3.75   # 3 cycles @ DDR3-1600
_CALIB_RC_NS = 1.25       # 1 cycle  @ DDR3-1600
# LISA's RBM (row-buffer-movement) hop latency, calibrated so that the paper's
# adjacent-subarray 8KB copy totals 260.5 ns: 260.5/2 - tRC = 81.5 ns per hop.
LISA_T_RBM_HOP_NS = 81.5


def memcpy_copy(t: T.DramTiming = T.DDR3_1600, *, src: int = 0, dst: int = 1
                ) -> CopyResult:
    """Copy one row over the off-chip memory channel (read out + write back)."""
    n = t.bursts_per_row
    read = t.tRCD + t.CL + n * t.tCCD
    write = t.tRCD + t.CWL + n * t.tCCD + t.tWR + t.tRP
    lat = read + write + _CALIB_MEMCPY_NS
    timeline = (
        Command("ACT(src)+READ burst x%d" % n, 0.0, read),
        Command("ACT(dst)+WRITE burst x%d" % n, read, write + _CALIB_MEMCPY_NS),
    )
    energy = T.E_CHANNEL_PER_BYTE * 2 * t.row_bytes
    return CopyResult("memcpy", lat, energy, timeline,
                      stalled_subarrays=_span(src, dst), occupies_bus=False,
                      occupies_channel=True)


def rc_intersa_copy(t: T.DramTiming = T.DDR3_1600, *, src: int = 0, dst: int = 1
                    ) -> CopyResult:
    """RowClone inter-subarray copy: two serial (PSM) legs via a temporary bank.

    Each leg streams the row through the bank global row buffer at tCCD
    cadence (the GRB is narrower than the row — RowClone's PSM bottleneck).
    """
    n = t.bursts_per_row
    leg = t.tRCD + t.CL + n * t.tCCD + t.tRP + _CALIB_RC_NS / 2
    lat = 2 * leg
    timeline = (
        Command("RC-PSM leg 1 (src -> temp bank)", 0.0, leg),
        Command("RC-PSM leg 2 (temp bank -> dst)", leg, leg),
    )
    energy = T.E_GRB_PER_BYTE * 2 * t.row_bytes
    return CopyResult("RC-InterSA", lat, energy, timeline,
                      stalled_subarrays=_span(src, dst), occupies_bus=False,
                      occupies_channel=True)


def rc_intrasa_copy(t: T.DramTiming = T.DDR3_1600, *, subarray: int = 0
                    ) -> CopyResult:
    """RowClone FPM copy between two rows of the SAME subarray (AAP primitive).

    Two overlapped ACTIVATEs (t_overlap apart, per AMBIT) + restore + precharge.
    This is also the primitive Shared-PIM uses to stage data into a shared row.
    """
    lat = t.t_overlap + t.tRAS + t.tRP
    timeline = (
        Command("ACT(src row)", 0.0, t.tRAS),
        Command("ACT(dst row)", t.t_overlap, t.tRAS),
        Command("PRE", t.t_overlap + t.tRAS, t.tRP),
    )
    energy = 2 * T.E_ACT_ROW
    return CopyResult("RC-IntraSA", lat, energy, timeline,
                      stalled_subarrays=(subarray,), occupies_bus=False,
                      occupies_channel=False)


def lisa_copy(t: T.DramTiming = T.DDR3_1600, *, src: int = 0, dst: int = 1,
              distance: int | None = None) -> CopyResult:
    """LISA inter-subarray copy via Row-Buffer-Movement hop chains.

    The open-bitline structure splits the copy into TWO half-row steps
    (Fig 3); each step activates the source half and chains ``d`` RBM hops to
    reach the destination.  Latency grows linearly with distance, and every
    subarray in [src, dst] has its bitlines linked — i.e. stalled — for the
    whole copy (the paper's key criticism).
    """
    d = abs(dst - src) if distance is None else distance
    if d < 1:
        raise ValueError("LISA inter-subarray copy needs distance >= 1")
    step = t.tRAS + d * LISA_T_RBM_HOP_NS + t.tRP
    lat = 2 * step
    timeline = (
        Command("ACT(src) + RBM x%d (half 1)" % d, 0.0, step),
        Command("ACT(src) + RBM x%d (half 2)" % d, step, step),
    )
    # 2 half-steps x (src ACT + 2 RBM-linked SA rows per hop + dst restore)
    energy = (4 + 4 * d) * T.E_ACT_ROW
    return CopyResult("LISA", lat, energy, timeline,
                      stalled_subarrays=_span(src, dst), occupies_bus=False,
                      occupies_channel=False)


def sharedpim_copy(t: T.DramTiming = T.DDR3_1600, *, src: int = 0, dst: int = 1,
                   staged: bool = True, restore: bool = True) -> CopyResult:
    """Shared-PIM inter-subarray copy over the BK-bus.

    The bus transaction itself is two overlapped GWL ACTIVATEs (src shared row
    drives the bus; dst shared row latches it) + restore + precharge:

        t_bus = t_overlap + tRAS + tRP = 4 + 35 + 13.75 = 52.75 ns   (Table II)

    ``staged=True`` means the operand already lives in the source shared row
    and the consumer reads directly from the destination shared row — the
    steady-state of a pipelined computation (the paper's 2-shared-rows-per-
    subarray configuration exists precisely to make this the common case).
    With ``staged=False``/``restore=False`` the model prepends/appends the
    intra-subarray RowClone needed to move data between a regular row and the
    shared row; the full unstaged path is 3 x 52.75 = 158.25 ns (Table IV).

    Distance-independent: the BK-bus reaches every subarray in one hop.
    Crucially, ``stalled_subarrays`` is EMPTY for the bus leg — local sense
    amplifiers keep computing while the bus moves data.
    """
    bus = t.t_overlap + t.tRAS + t.tRP
    cmds = [Command("BK-bus: ACT(GWL src) || ACT(GWL dst) + PRE", 0.0, bus)]
    lat = bus
    stalled: list[int] = []
    if not staged:
        stage = rc_intrasa_copy(t, subarray=src)
        cmds.insert(0, Command("stage: RC-IntraSA(src row -> shared row)",
                               0.0, stage.latency_ns))
        cmds[1] = dataclasses.replace(cmds[1], start_ns=stage.latency_ns)
        lat += stage.latency_ns
        stalled.append(src)
    if not restore:
        rest = rc_intrasa_copy(t, subarray=dst)
        cmds.append(Command("restore: RC-IntraSA(shared row -> dst row)",
                            lat, rest.latency_ns))
        lat += rest.latency_ns
        stalled.append(dst)
    energy = 2 * T.E_ACT_ROW + T.DEFAULT_GEOMETRY.bus_segments * T.E_BKSA_SEGMENT_ROW
    if not staged:
        energy += 2 * T.E_ACT_ROW
    if not restore:
        energy += 2 * T.E_ACT_ROW
    return CopyResult("Shared-PIM", lat, energy, tuple(cmds),
                      stalled_subarrays=tuple(stalled), occupies_bus=True,
                      occupies_channel=False)


def sharedpim_broadcast(t: T.DramTiming = T.DDR3_1600, *, src: int = 0,
                        dests: Sequence[int] = (1, 2, 3, 4)) -> CopyResult:
    """One-to-many copy over the BK-bus (Sec IV-B SPICE-validated, <=4 dests).

    Destination GWL ACTIVATEs are pipelined at t_overlap offsets after the
    source activation, so the cost of each extra destination is only 4 ns.
    """
    n = len(dests)
    if n > T.DEFAULT_GEOMETRY.max_broadcast_dests:
        raise ValueError(
            f"broadcast fan-out {n} exceeds the SPICE-validated DDR-timing "
            f"limit of {T.DEFAULT_GEOMETRY.max_broadcast_dests}")
    lat = n * t.t_overlap + t.tRAS + t.tRP
    timeline = tuple(
        [Command("BK-bus: ACT(GWL src)", 0.0, t.tRAS)]
        + [Command(f"ACT(GWL dst {d})", (i + 1) * t.t_overlap, t.tRAS)
           for i, d in enumerate(dests)]
        + [Command("PRE", lat - t.tRP, t.tRP)])
    energy = (1 + n) * T.E_ACT_ROW \
        + T.DEFAULT_GEOMETRY.bus_segments * T.E_BKSA_SEGMENT_ROW
    return CopyResult("Shared-PIM-broadcast", lat, energy, timeline,
                      stalled_subarrays=(), occupies_bus=True,
                      occupies_channel=False)


def table2() -> dict[str, tuple[float, float]]:
    """Reproduce Table II: {mechanism: (latency_ns, energy_uJ)} for 8KB."""
    rows = {
        "memcpy (via mem. channel)": memcpy_copy(),
        "RC-InterSA": rc_intersa_copy(),
        "LISA": lisa_copy(distance=1),
        "Shared-PIM": sharedpim_copy(),
    }
    return {k: (v.latency_ns, v.energy_j * 1e6) for k, v in rows.items()}
