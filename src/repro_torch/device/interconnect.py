"""Inter-bank and cross-channel transfer cost models.
(PyTorch port of ``repro/device/interconnect.py``: plain
Python floats, the same expressions in the same order.)

Layered on :mod:`repro_torch.core.copy_models`: intra-bank semantics (LISA RBM
chains vs the Shared-PIM BK-bus) are untouched; this module prices the legs a
row crosses once it leaves its bank.  Every cross-bank move decomposes into

    drain  (src subarray -> bank bus port)   intra-bank, mode dependent
    transit (bank -> bank over shared buses)  mode independent per row
    fill   (bank bus port -> dst subarray)   intra-bank, mode dependent

with transit cost set by the route class (:meth:`DeviceGeometry.route`):

========== ================================================= ================
route      bus resources held                                 ns / 8KB row
========== ================================================= ================
group      one bank-group global bus                          grb_stream_ns
channel    both group buses + the channel I/O bus             channel_stream_ns
device     both group buses + both channels' I/O              channel + grb
fleet      the above + both devices' off-package links        2x channel + grb
========== ================================================= ================

The ``fleet`` route crosses device boundaries: the row exits through the
source device's channel I/O, flies the off-package link, and is written in
through the destination device's channel I/O — two full channel-stream
legs instead of one, which is exactly the HBM-PIM fleet model's
``FC_devices`` cost structure (off-package transfers are priced as a
second I/O crossing, not a new technology constant).

The two interconnects differ in *concurrency*, exactly as intra-bank:

* **LISA** has no staging buffer between a subarray row buffer and the bank
  port — the whole path is circuit-switched.  A cross-bank move holds the
  source RBM span, the transit buses, and the destination span for its full
  ``rows x (drain + transit + fill)`` duration, stalling computation in both
  spans (the paper's criticism, amplified at device scale).
* **Shared-PIM** stages rows in shared rows at each hop, so the three legs
  pipeline (store-and-forward): each resource is held only for its own leg,
  at ~``rows x transit`` steady state, and no PE anywhere stalls.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import copy_models, timing as T
from repro_torch.core.pluto import Interconnect
from repro_torch.device.geometry import DeviceGeometry

#: energy to stream one row over a bank-group global bus (same per-byte cost
#: as the RowClone global-row-buffer leg it structurally matches)
E_GROUP_TRANSIT_ROW = T.E_GRB_PER_BYTE * T.DDR3_1600.row_bytes
#: energy to cross the channel I/O (read + write leg, memcpy coefficient)
E_CHANNEL_TRANSIT_ROW = T.E_CHANNEL_PER_BYTE * 2 * T.DDR3_1600.row_bytes


def transit_ns_per_row(route: str, t: T.DramTiming = T.DDR3_1600) -> float:
    """Per-row latency of the inter-bank transit leg for a route class."""
    if route == "group":
        return t.grb_stream_ns
    if route == "channel":
        return t.channel_stream_ns
    if route == "device":
        return t.channel_stream_ns + t.grb_stream_ns
    if route == "fleet":
        # exit the source device's channel I/O, cross the off-package link,
        # enter the destination device's channel I/O: two I/O crossings plus
        # the group-bus hop the device route already pays
        return 2 * t.channel_stream_ns + t.grb_stream_ns
    raise ValueError(f"not a cross-bank route: {route!r}")


def transit_energy_per_row(route: str) -> float:
    """Energy analog of :func:`transit_ns_per_row`, leg for leg.

    ``group`` is one internal streaming leg; ``channel`` stays on-die (read
    leg out of the source group + write leg into the destination group — no
    off-chip I/O, so two GRB-coefficient passes); ``device`` additionally
    crosses the off-chip channel I/O and pays the extra group-bus hop its
    latency model includes.
    """
    if route == "group":
        return E_GROUP_TRANSIT_ROW
    if route == "channel":
        return 2 * E_GROUP_TRANSIT_ROW
    if route == "device":
        return E_CHANNEL_TRANSIT_ROW + E_GROUP_TRANSIT_ROW
    if route == "fleet":
        return 2 * E_CHANNEL_TRANSIT_ROW + E_GROUP_TRANSIT_ROW
    raise ValueError(f"not a cross-bank route: {route!r}")


@dataclasses.dataclass(frozen=True)
class CrossBankPlan:
    """Priced legs of one cross-bank row stream (all latencies per row)."""

    route: str
    drain_ns: float
    transit_ns: float
    fill_ns: float
    circuit_switched: bool      # True under LISA: all resources held end-to-end
    # Energy of the drain + transit legs per row.  The fill (delivery) leg is
    # deliberately NOT priced here: the scheduler charges one flat per-row
    # delivery coefficient for every destination, cross-bank or not, so that
    # a single-bank device reproduces the core energy accounting exactly.
    drain_energy_j: float
    transit_energy_j: float

    def total_ns(self, rows: int) -> float:
        """End-to-end latency of ``rows`` row hand-offs.

        Circuit-switched (LISA): strictly serial, rows x (sum of legs).
        Store-and-forward (Shared-PIM): legs pipeline across rows; the
        slowest leg (transit, for any multi-bank route) sets the cadence.
        """
        if self.circuit_switched:
            return rows * (self.drain_ns + self.transit_ns + self.fill_ns)
        cadence = max(self.drain_ns, self.transit_ns, self.fill_ns)
        return self.drain_ns + self.transit_ns + self.fill_ns \
            + (rows - 1) * cadence


def plan(mode: Interconnect, geom: DeviceGeometry, src_pe: int, dst_pe: int,
         t: T.DramTiming = T.DDR3_1600) -> CrossBankPlan:
    """Price a single-destination cross-bank move between global PE ids."""
    src_bank, dst_bank = geom.bank_of(src_pe), geom.bank_of(dst_pe)
    route = geom.route(src_bank, dst_bank)
    if route == "intra":
        raise ValueError("plan() is for cross-bank moves; use the intra-bank "
                         "copy models for same-bank transfers")
    transit = transit_ns_per_row(route, t)
    e_transit = transit_energy_per_row(route)
    src_local, dst_local = geom.local_of(src_pe), geom.local_of(dst_pe)
    if mode is Interconnect.LISA:
        # RBM-chain the row to/from the bank port (subarray 0 side); the
        # subarray row buffer drives the bus directly, so the whole path is
        # one circuit: spans + buses held for the full duration.
        drain = copy_models.lisa_copy(t, distance=max(1, src_local))
        fill = copy_models.lisa_copy(t, distance=max(1, dst_local))
        return CrossBankPlan(route, drain.latency_ns, transit, fill.latency_ns,
                             circuit_switched=True,
                             drain_energy_j=drain.energy_j,
                             transit_energy_j=e_transit)
    # Shared-PIM: one BK-bus hop stages the row into the port shared row,
    # decoupling the legs — store-and-forward, nobody stalls.
    hop = copy_models.sharedpim_copy(t)
    return CrossBankPlan(route, hop.latency_ns, transit, hop.latency_ns,
                         circuit_switched=False,
                         drain_energy_j=hop.energy_j,
                         transit_energy_j=e_transit)
