"""Device-scale resource model for the resource-token event engine
(PyTorch port of ``repro/device/resources.py``).

Maps a full :class:`~repro_torch.device.geometry.DeviceGeometry` onto one flat
array of resource tokens and compiles every move into the engine's
declarative claim segments:

Token layout (``n`` = PEs per bank, ``stride = 3n + 1`` per bank)::

    bank b:   PE p            -> b*stride + p
              BK-bus          -> b*stride + n
              tx shared row p -> b*stride + n + 1 + p
              rx shared row p -> b*stride + 2n + 1 + p
    group bus g    -> n_banks*stride + g
    channel bus c  -> n_banks*stride + n_groups + c
    d2d link v     -> n_banks*stride + n_groups + n_channels + v
                      (fleet geometries only: one off-package link per device)

Intra-bank moves compile to the exact single-bank segments of
:class:`~repro_torch.core.engine.BankModel`, just offset into the owning bank's
token block.  Cross-bank moves split per destination bank and compile to:

* **LISA** — one CIRCUIT segment claiming the source RBM span (port
  subarray 0 up to the source), the destination span, and every transit bus
  on the route for the full duration: circuit switching, both spans stall.
* **Shared-PIM** — one SAF segment whose drain / transit / fill legs each
  hold only their own tokens (source bus+tx, route buses, destination
  bus+rx) for their own pipelined window: store-and-forward, nobody stalls.

Cross-bank leg prices come from :func:`repro_torch.device.interconnect.plan`,
memoized per (route, source subarray, destination subarray) — the legacy
scheduler re-derived the plan dataclass for every move on every pop.

A graph's tensors are host tensors, and so is everything here: the model
compiles to Python lists, which an engine session copies to its device.
"""

from __future__ import annotations

import torch

from repro_torch.core import engine
from repro_torch.core.energy import move_energy
from repro_torch.core.engine import CIRCUIT, SAF, Compiled, move_latency
from repro_torch.core.ir import OP, TaskGraph
from repro_torch.core.pluto import Interconnect
from repro_torch.device import interconnect as xbar
from repro_torch.device.geometry import DeviceGeometry


class DeviceModel(engine.ResourceModel):
    """All interconnect semantics of one DRAM device, as token claims."""

    def __init__(self, mode: Interconnect, geom: DeviceGeometry):
        self.mode = mode
        self.geom = geom
        self._plan_cache: dict = {}
        # compiled segments + priority latency are pure in the move's raw
        # (src, dsts, rows) signature; app graphs repeat few signatures many
        # times, and a model reused across a sweep amortizes them further
        self._move_cache: dict = {}

    # --- token layout -----------------------------------------------------------

    @property
    def _stride(self) -> int:
        return 3 * self.geom.pes_per_bank + 1

    def _bus(self, bank: int) -> int:
        return bank * self._stride + self.geom.pes_per_bank

    def _tx(self, bank: int, local: int) -> int:
        return bank * self._stride + self.geom.pes_per_bank + 1 + local

    def _rx(self, bank: int, local: int) -> int:
        return bank * self._stride + 2 * self.geom.pes_per_bank + 1 + local

    def _group_bus(self, g: int) -> int:
        return self.geom.n_banks * self._stride + g

    def _chan_bus(self, c: int) -> int:
        return self.geom.n_banks * self._stride + self.geom.n_groups + c

    def _d2d_link(self, v: int) -> int:
        return self.geom.n_banks * self._stride + self.geom.n_groups \
            + self.geom.n_channels + v

    def n_resources(self) -> int:
        geom = self.geom
        # single-device geometries carry no off-package links, keeping the
        # token layout (and every golden schedule) byte-identical to the
        # pre-fleet model
        d2d = geom.devices if geom.devices > 1 else 0
        return geom.n_banks * self._stride + geom.n_groups \
            + geom.n_channels + d2d

    def bus_classes(self) -> tuple[str, ...]:
        if self.geom.devices > 1:
            return ("bank_group", "channel", "d2d")
        return ("bank_group", "channel")

    def refresh_units(self) -> tuple[tuple[int, ...], ...]:
        """One refresh unit per bank: its PEs, BK-bus and shared rows.

        The bank-group and channel buses are I/O wiring, not DRAM cells —
        they carry no refresh claims, so cross-bank transit of *other*
        banks keeps flowing while a bank refreshes (per-bank refresh).
        """
        stride = self._stride
        return tuple(tuple(range(b * stride, (b + 1) * stride))
                     for b in range(self.geom.n_banks))

    def token_names(self) -> tuple[str, ...]:
        """Trace track label per token, mirroring the layout above."""
        geom = self.geom
        n = geom.pes_per_bank
        names: list[str] = []
        for b in range(geom.n_banks):
            names.extend(f"bank{b}/pe{p}" for p in range(n))
            names.append(f"bank{b}/bk-bus")
            names.extend(f"bank{b}/tx{p}" for p in range(n))
            names.extend(f"bank{b}/rx{p}" for p in range(n))
        names.extend(f"group-bus{g}" for g in range(geom.n_groups))
        names.extend(f"chan-bus{c}" for c in range(geom.n_channels))
        if geom.devices > 1:
            names.extend(f"d2d-link{v}" for v in range(geom.devices))
        return tuple(names)

    def refresh_unit_names(self) -> tuple[str, ...]:
        return tuple(f"refresh/bank{b}" for b in range(self.geom.n_banks))

    def _plan(self, src_pe: int, dst_pe: int) -> xbar.CrossBankPlan:
        geom = self.geom
        key = (geom.route(geom.bank_of(src_pe), geom.bank_of(dst_pe)),
               geom.local_of(src_pe), geom.local_of(dst_pe))
        p = self._plan_cache.get(key)
        if p is None:
            p = self._plan_cache[key] = xbar.plan(self.mode, geom,
                                                  src_pe, dst_pe)
        return p

    # --- compilation ------------------------------------------------------------

    def _intra_segment(self, bank: int, src_local: int, dsts_local: list,
                       rows: int) -> tuple:
        """One intra-bank move segment inside ``bank``'s token block."""
        lat = move_latency(self.mode, src_local, dsts_local, rows)
        base = bank * self._stride
        if self.mode is Interconnect.LISA:
            lo = min(src_local, *dsts_local)
            hi = max(src_local, *dsts_local)
            # one subtotaled stall group per span: bit-compatible with the
            # legacy device engine's lisa_span_hold accounting
            return (CIRCUIT, tuple(range(base + lo, base + hi + 1)),
                    (hi - lo + 1,), lat, (), 0.0)
        return (CIRCUIT,
                (self._bus(bank), self._tx(bank, src_local),
                 *(self._rx(bank, d) for d in dsts_local)),
                (), lat, (), 0.0)

    def _cross_segment(self, gsrc: int, dst_bank: int, group: list,
                       rows: int) -> tuple:
        geom = self.geom
        src_bank = geom.bank_of(gsrc)
        src_local = geom.local_of(gsrc)
        dsts_local = [geom.local_of(d) for d in group]
        route = geom.route(src_bank, dst_bank)
        p = self._plan(gsrc, group[0])
        gbuses, cbuses, dlinks = _transit_resources(geom, src_bank, dst_bank,
                                                    route)
        bus_rids = tuple([self._group_bus(g) for g in gbuses]
                         + [self._chan_bus(c) for c in cbuses]
                         + [self._d2d_link(v) for v in dlinks])
        busy_keys = ("bank_group",) * len(gbuses) \
            + ("channel",) * len(cbuses) + ("d2d",) * len(dlinks)
        # fan-out from the bank port to every destination in the bank rides
        # the intra-bank interconnect
        fill = move_latency(self.mode, 0, dsts_local, rows)
        energy = rows * (p.drain_energy_j + p.transit_energy_j)
        if self.mode is Interconnect.LISA:
            dur = rows * (p.drain_ns + p.transit_ns) + fill
            src_base = src_bank * self._stride
            dst_base = dst_bank * self._stride
            rids = (tuple(range(src_base, src_base + src_local + 1))
                    + tuple(range(dst_base,
                                  dst_base + max(dsts_local) + 1))
                    + bus_rids)
            return (CIRCUIT, rids, (src_local + 1, max(dsts_local) + 1),
                    dur, busy_keys, energy)
        drain = rows * p.drain_ns
        transit = rows * p.transit_ns
        leg1 = (self._bus(src_bank), self._tx(src_bank, src_local))
        leg3 = (self._bus(dst_bank),
                *(self._rx(dst_bank, d) for d in dsts_local))
        return (SAF, leg1, bus_rids, leg3, drain, transit, fill,
                p.drain_ns, p.transit_ns, p.fill_ns,
                drain + transit + fill, busy_keys, energy)

    def _priority_latency(self, gsrc: int, raw_src: int, raw_dsts: list,
                          gdsts: list, rows: int,
                          split: dict) -> float:
        """Contention-free move latency used as list-scheduling priority.

        Replicates the legacy ``_device_move_latency`` exactly, including
        its quirk of pricing the all-intra case on the *raw* (unwrapped)
        ids while cross-bank plans use wrapped global ids.
        """
        geom = self.geom
        src_bank = geom.bank_of(gsrc)
        if all(geom.bank_of(d) == src_bank for d in gdsts):
            return move_latency(self.mode, raw_src, raw_dsts, rows)
        total = 0.0
        for bank, group in split.items():
            if bank == src_bank:
                total += move_latency(self.mode, gsrc, tuple(group), rows)
                continue
            p = self._plan(gsrc, group[0])
            total += p.total_ns(rows)
            if len(group) > 1:
                total += move_latency(self.mode, bank * geom.pes_per_bank,
                                      tuple(group[1:]), rows)
        return total

    def compile(self, g: TaskGraph) -> Compiled:
        geom = self.geom
        total_pes = geom.total_pes
        ppb = geom.pes_per_bank

        src = g.src.tolist()
        rows_arr = g.rows.tolist()
        dst_indptr = g.dst_indptr.tolist()
        dst_flat = g.dst_flat.tolist()

        # ops vectorized: token id per op, duration-as-priority; move slots
        # are overwritten below
        gpe = g.pe % total_pes
        prio = g.duration.tolist()
        exec_plan: list = list(zip(
            ((gpe // ppb) * self._stride + gpe % ppb).tolist(), prio))
        e_op = self.energy_table().op_j
        task_energy: list = [e_op] * g.n
        energy_move = 0.0
        move_idx = torch.nonzero(g.kinds != OP).flatten()
        n_rows = n_cross = 0
        rows_by_route: dict = {}

        # moves grouped by (src, dst, rows) signature: an app graph repeats
        # a few hundred signatures tens of thousands of times, so compile
        # each unique signature once and fan the result out
        n_dsts = torch.diff(g.dst_indptr)[move_idx]
        single = move_idx[n_dsts == 1]
        multi = move_idx[n_dsts != 1]
        if len(single):
            sig = torch.stack([g.src[single],
                               g.dst_flat[g.dst_indptr[single]],
                               g.rows[single]], dim=1)
            # torch.unique over rows returns them in ascending lexicographic
            # order, as the reference's np.unique(axis=0) does: that order
            # sets the float accumulation order of energy_move and the
            # insertion order of rows_by_route, so it must not change
            uniq, inv = torch.unique(sig, dim=0, sorted=True,
                                     return_inverse=True)
            sig_counts = torch.bincount(inv)
            hits = []
            for s, d0, r in uniq.tolist():
                hits.append(self._compile_move(s, [d0], r))
            for u, cnt in zip(hits, sig_counts.tolist()):
                n_rows += u[2] * cnt
                n_cross += u[3] * cnt
                for route, n in u[4]:
                    rows_by_route[route] = rows_by_route.get(route, 0) \
                        + n * cnt
                energy_move += u[5] * cnt
            inv_l = inv.tolist()
            for j, i in enumerate(single.tolist()):
                hit = hits[inv_l[j]]
                exec_plan[i] = hit[0]
                prio[i] = hit[1]
                task_energy[i] = hit[5]
        for i in multi.tolist():
            raw_dsts = dst_flat[dst_indptr[i]:dst_indptr[i + 1]]
            key = (src[i], tuple(raw_dsts), rows_arr[i])
            hit = self._move_cache.get(key)
            if hit is None:
                hit = self._move_cache[key] = self._compile_move(
                    src[i], raw_dsts, rows_arr[i])
            exec_plan[i] = hit[0]
            prio[i] = hit[1]
            n_rows += hit[2]
            n_cross += hit[3]
            for route, n in hit[4]:
                rows_by_route[route] = rows_by_route.get(route, 0) + n
            task_energy[i] = hit[5]
            energy_move += hit[5]
        n_ops = g.n - len(move_idx)
        return Compiled(self.n_resources(), exec_plan, prio,
                        n_ops=n_ops, n_moves=len(move_idx),
                        n_rows=n_rows, n_cross=n_cross,
                        rows_by_route=rows_by_route,
                        task_energy_j=task_energy,
                        energy_op_j=n_ops * e_op,
                        energy_move_j=energy_move)

    def _compile_move(self, raw_src: int, raw_dsts: list, r: int) -> tuple:
        """(exec_tuple, priority_ns, rows_delivered, is_cross, route_rows,
        energy_j) for one move signature — memoized via _move_cache.

        ``energy_j`` is the fully-metered price of the move: intra-bank
        legs via :func:`move_energy` (the latency model's twin), cross-bank
        legs as drain + transit per the interconnect plan plus the fill
        delivery from the bank port over the intra-bank interconnect.
        """
        key = (raw_src,
               raw_dsts[0] if len(raw_dsts) == 1 else tuple(raw_dsts), r)
        hit = self._move_cache.get(key)
        if hit is not None:
            return hit
        geom = self.geom
        total_pes = geom.total_pes
        ppb = geom.pes_per_bank
        gsrc = raw_src % total_pes
        gdsts = [d % total_pes for d in raw_dsts]
        src_bank = gsrc // ppb
        split: dict = {}
        for d in gdsts:
            split.setdefault(d // ppb, []).append(d)
        cross = any(b != src_bank for b in split)
        if not cross:
            seg = self._intra_segment(
                src_bank, gsrc % ppb, [d % ppb for d in gdsts], r)
            # pre-flattened single-segment form (engine fast path)
            exec_t = (seg[1], seg[2], seg[3])
            route_rows = (("intra", r * len(gdsts)),)
            e_move = move_energy(self.mode, gsrc % ppb,
                                 [d % ppb for d in gdsts], r)
        else:
            exec_t = (tuple(
                self._intra_segment(src_bank, gsrc % ppb,
                                    [d % ppb for d in group], r)
                if bank == src_bank
                else self._cross_segment(gsrc, bank, group, r)
                for bank, group in split.items()),)
            route_rows = tuple(
                ("intra" if bank == src_bank
                 else geom.route(src_bank, bank), r * len(group))
                for bank, group in split.items())
            e_move = 0.0
            for bank, group in split.items():
                dsts_local = [d % ppb for d in group]
                if bank == src_bank:
                    e_move += move_energy(self.mode, gsrc % ppb,
                                          dsts_local, r)
                else:
                    p = self._plan(gsrc, group[0])
                    e_move += r * (p.drain_energy_j + p.transit_energy_j) \
                        + move_energy(self.mode, 0, dsts_local, r)
        hit = self._move_cache[key] = (
            exec_t,
            self._priority_latency(gsrc, raw_src, raw_dsts, gdsts, r, split),
            r * len(gdsts), cross, route_rows, e_move)
        return hit


def _transit_resources(
        geom: DeviceGeometry, src_bank: int, dst_bank: int,
        route: str) -> tuple[list[int], list[int], list[int]]:
    """(group-bus, channel-bus, d2d-link indices) held by the transit leg."""
    sg, dg = geom.group_of_bank(src_bank), geom.group_of_bank(dst_bank)
    sc, dc = geom.channel_of_bank(src_bank), geom.channel_of_bank(dst_bank)
    if route == "group":
        return [sg], [], []
    if route == "channel":
        return [sg, dg], [sc], []
    if route == "device":
        return [sg, dg], [sc, dc], []
    # "fleet": both devices' channel I/O plus their off-package links
    return [sg, dg], [sc, dc], [geom.device_of_bank(src_bank),
                                geom.device_of_bank(dst_bank)]
