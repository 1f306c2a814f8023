"""Device-scale DRAM organization: subarray -> bank -> bank group -> channel.
(PyTorch port of ``repro/device/geometry.py``:
plain Python, verbatim.)

The single-bank simulator (:mod:`repro_torch.core.scheduler`) models one bank
of ``pes_per_bank`` subarray PEs.  :class:`DeviceGeometry` stacks those banks
into the full device hierarchy (mirroring the Bank -> BankGroup -> Channel ->
Device structure of trace-driven PIM simulators):

* every bank keeps its private intra-bank interconnect (LISA RBM chains or
  the Shared-PIM BK-bus — the paper's subject);
* banks within a bank group share one *bank-group global bus*;
* bank groups within a channel share the *channel I/O bus*;
* channels are fully independent (separate I/O, separate buses).

PEs are addressed by a flat **global PE id**: bank ``b``'s subarrays occupy
``[b * pes_per_bank, (b + 1) * pes_per_bank)``, and banks are numbered
channel-major (bank ``b`` lives in channel ``b // banks_per_channel``).
Task graphs scheduled by :mod:`repro_torch.device.scheduler` use these
global ids; a 1-channel / 1-bank geometry therefore degenerates to exactly the
single-bank id space.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DeviceGeometry:
    """Shape of one DRAM device (or a fleet of them) for the simulator.

    ``devices`` stacks whole devices into a fleet: each device keeps its
    own channels/groups/banks, and cross-device transfers ride per-device
    off-package links (the ``"fleet"`` route class).  ``channels`` etc.
    remain *per-device* counts; ``n_channels``/``n_groups``/``n_banks``
    are fleet-wide totals.
    """

    channels: int = 1
    banks_per_channel: int = 1
    bank_groups_per_channel: int = 1
    pes_per_bank: int = 16
    devices: int = 1

    def __post_init__(self) -> None:
        for field in ("devices", "channels", "banks_per_channel",
                      "bank_groups_per_channel", "pes_per_bank"):
            v = getattr(self, field)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{field} must be a positive int, got {v!r}")
        if self.banks_per_channel % self.bank_groups_per_channel:
            raise ValueError(
                f"banks_per_channel ({self.banks_per_channel}) must be a "
                f"multiple of bank_groups_per_channel "
                f"({self.bank_groups_per_channel})")

    # --- sizes ------------------------------------------------------------------

    @property
    def banks_per_group(self) -> int:
        return self.banks_per_channel // self.bank_groups_per_channel

    @property
    def banks_per_device(self) -> int:
        return self.channels * self.banks_per_channel

    @property
    def n_channels(self) -> int:
        """Fleet-wide channel count (``devices x channels``)."""
        return self.devices * self.channels

    @property
    def n_banks(self) -> int:
        return self.devices * self.channels * self.banks_per_channel

    @property
    def n_groups(self) -> int:
        return self.devices * self.channels * self.bank_groups_per_channel

    @property
    def total_pes(self) -> int:
        return self.n_banks * self.pes_per_bank

    # --- addressing -------------------------------------------------------------

    def bank_of(self, pe: int) -> int:
        return (pe % self.total_pes) // self.pes_per_bank

    def local_of(self, pe: int) -> int:
        return pe % self.pes_per_bank

    def pe(self, bank: int, local: int) -> int:
        if not 0 <= bank < self.n_banks:
            raise ValueError(f"bank {bank} out of range [0, {self.n_banks})")
        return bank * self.pes_per_bank + local % self.pes_per_bank

    def channel_of_bank(self, bank: int) -> int:
        """Fleet-global channel index (banks are numbered device-major)."""
        return bank // self.banks_per_channel

    def device_of_bank(self, bank: int) -> int:
        return bank // self.banks_per_device

    def group_of_bank(self, bank: int) -> int:
        """Global bank-group index (unique across channels and devices)."""
        ch = self.channel_of_bank(bank)
        within = (bank % self.banks_per_channel) // self.banks_per_group
        return ch * self.bank_groups_per_channel + within

    # --- routing ----------------------------------------------------------------

    def route(self, src_bank: int, dst_bank: int) -> str:
        """Topological class of the cheapest legal path between two banks.

        ``"intra"``   same bank (no transit; intra-bank interconnect only)
        ``"group"``   same bank group (one bank-group bus hop)
        ``"channel"`` same channel, different group (group buses + channel bus)
        ``"device"``  same device, different channels (both channels' I/O)
        ``"fleet"``   different devices (both devices' off-package links)
        """
        if src_bank == dst_bank:
            return "intra"
        if self.group_of_bank(src_bank) == self.group_of_bank(dst_bank):
            return "group"
        if self.channel_of_bank(src_bank) == self.channel_of_bank(dst_bank):
            return "channel"
        if self.device_of_bank(src_bank) == self.device_of_bank(dst_bank):
            return "device"
        return "fleet"

    def describe(self) -> str:
        dev = f"{self.devices}dev x " if self.devices > 1 else ""
        return (f"{dev}{self.channels}ch x {self.bank_groups_per_channel}bg x "
                f"{self.banks_per_group}banks x {self.pes_per_bank}PEs "
                f"({self.n_banks} banks, {self.total_pes} PEs)")


#: the degenerate geometry that reproduces the single-bank simulator exactly
SINGLE_BANK = DeviceGeometry(channels=1, banks_per_channel=1,
                             bank_groups_per_channel=1, pes_per_bank=16)
