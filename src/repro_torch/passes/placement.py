"""Validate / place / legalize passes (PyTorch port of
``repro/passes/placement.py``).

Placement is the physical decision the app builders and the model frontend no
longer bake in: they emit graphs over a *virtual* PE space, and one of these
passes maps every pe/src/dst onto the device.  The actual maps are still
:func:`repro_torch.device.partition.pe_map` /
:func:`~repro_torch.device.partition.lease_pe_map` — the policies did not move,
they became pipeline stages — so a pipeline with no optimization passes
reproduces the pre-pipeline placement path bit-for-bit.
"""

from __future__ import annotations

import torch

from repro_torch.core.ir import MOVE, NONE_SENTINEL, OP, TaskGraph
from repro_torch.passes.pipeline import Pass, RewriteLog


class ValidatePass(Pass):
    """Reject malformed graphs before any physical decision is made."""

    name = "validate"
    stage = "validate"

    def run(self, g: TaskGraph, log: RewriteLog) -> TaskGraph:
        g.validate()
        return g


class PlacePass(Pass):
    """Map virtual PEs onto a device geometry under a placement policy."""

    name = "place"
    stage = "place"

    def __init__(self, geom, policy: str = "locality_first"):
        self.geom = geom
        self.policy = policy

    def describe(self) -> str:
        return f"place[{self.policy}@{self.geom.describe()}]"

    def run(self, g: TaskGraph, log: RewriteLog) -> TaskGraph:
        # local: partition imports passes
        from repro_torch.device import partition
        return partition.place_ir(g, self.geom, self.policy)


class LeasePlacePass(Pass):
    """Map virtual PEs onto a leased bank set (the serving runtime's view)."""

    name = "lease_place"
    stage = "place"

    def __init__(self, geom, banks, policy: str = "locality_first"):
        self.geom = geom
        self.banks = tuple(banks)
        self.policy = policy

    def describe(self) -> str:
        return (f"lease_place[{self.policy}@{self.geom.describe()}"
                f":banks={','.join(map(str, self.banks))}]")

    def run(self, g: TaskGraph, log: RewriteLog) -> TaskGraph:
        # local: partition imports passes
        from repro_torch.device import partition
        return partition.place_on_banks(g, self.geom, self.banks, self.policy)


class LegalizePass(Pass):
    """Final structural checks on the physical graph.

    Re-validates (optimization passes must not have introduced cycles or
    dangling deps) and, when the target PE count is known, rejects graphs
    whose endpoints fall outside ``[0, total_pes)`` — a mis-specified
    placement otherwise hides behind the resource models' modulo wrap.
    """

    name = "legalize"
    stage = "legalize"

    def __init__(self, total_pes: int | None = None):
        self.total_pes = total_pes

    def describe(self) -> str:
        return "legalize" if self.total_pes is None \
            else f"legalize[{self.total_pes}pes]"

    def run(self, g: TaskGraph, log: RewriteLog) -> TaskGraph:
        g.validate()
        if self.total_pes is not None:
            total = self.total_pes
            ops = g.kinds == OP
            moves = g.kinds == MOVE
            bad = torch.zeros(g.n, dtype=torch.bool)
            bad |= ops & ((g.pe < 0) | (g.pe >= total)) \
                & (g.pe != NONE_SENTINEL)
            bad |= moves & ((g.src < 0) | (g.src >= total)) \
                & (g.src != NONE_SENTINEL)
            oob_dst = (g.dst_flat < 0) | (g.dst_flat >= total)
            if bool(oob_dst.any()):
                owners = torch.repeat_interleave(
                    torch.arange(g.n, dtype=torch.int64),
                    torch.diff(g.dst_indptr))
                bad[torch.unique(owners[oob_dst])] = True
            if bool(bad.any()):
                uids = sorted(g.uids[bad].tolist())
                raise ValueError(
                    f"placed graph addresses PEs outside [0, {total}): "
                    f"uids {uids[:20]}")
        return g
