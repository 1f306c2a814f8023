"""Legacy pure-Python device scheduler, preserved for differential use
(PyTorch port of ``repro/device/reference.py``: plain Python, verbatim,
over the port's :mod:`repro_torch.core.reference`).

This is the pre-refactor implementation of :func:`repro_torch.device.scheduler
.schedule`, kept verbatim (like :mod:`repro_torch.core.reference`) so the
resource-token engine can be differential-tested against it bit-for-bit and
so the batch runner can be timed against the equivalent per-config
loop.  Do not extend it: device interconnect semantics belong in
:class:`repro_torch.device.resources.DeviceModel`.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Iterable, Sequence

from repro_torch.core import pluto
from repro_torch.core import reference as core_reference
from repro_torch.core import taskgraph
from repro_torch.core.pluto import Interconnect
from repro_torch.core.reference import Bank, _move_latency, _topo_order
from repro_torch.core.scheduler import Task, _dsts
from repro_torch.device import interconnect as xbar
from repro_torch.device.geometry import DeviceGeometry, SINGLE_BANK
from repro_torch.device.partition import pe_map
from repro_torch.device.scheduler import DeviceScheduleResult


def _remap(tasks: Iterable[Task], pe_map: Sequence[int]) -> list[Task]:
    """The pre-refactor per-Task placement remap, preserved verbatim.

    The live partitioner routes every representation through the one IR remap
    (:func:`repro_torch.device.partition._remap_ir`); this copy exists only so
    the legacy baseline this module preserves stays self-contained.
    """
    out = []
    for t in tasks:
        out.append(dataclasses.replace(
            t,
            pe=None if t.pe is None else pe_map[t.pe],
            src=None if t.src is None else pe_map[t.src],
            dst=None if t.dst is None else (
                tuple(pe_map[d] for d in t.dst) if isinstance(t.dst, tuple)
                else pe_map[t.dst])))
    return out


class _DeviceState:
    """Free-time bookkeeping for every resource in the hierarchy."""

    def __init__(self, geom: DeviceGeometry):
        self.banks = [Bank(geom.pes_per_bank) for _ in range(geom.n_banks)]
        self.group_bus_free = [0.0] * geom.n_groups
        self.chan_bus_free = [0.0] * geom.channels


def _transit_resources(geom: DeviceGeometry, src_bank: int, dst_bank: int,
                       route: str) -> tuple[list[int], list[int]]:
    """(group-bus indices, channel-bus indices) held by the transit leg."""
    sg, dg = geom.group_of_bank(src_bank), geom.group_of_bank(dst_bank)
    sc, dc = geom.channel_of_bank(src_bank), geom.channel_of_bank(dst_bank)
    if route == "group":
        return [sg], []
    if route == "channel":
        return [sg, dg], [sc]
    return [sg, dg], [sc, dc]          # "device"


def _split_by_bank(geom: DeviceGeometry, dsts: tuple[int, ...]
                   ) -> dict[int, list[int]]:
    """Destinations grouped by bank, preserving first-appearance order."""
    groups: dict[int, list[int]] = {}
    for d in dsts:
        groups.setdefault(geom.bank_of(d), []).append(d)
    return groups


def _device_move_latency(mode: Interconnect, geom: DeviceGeometry,
                         t: Task) -> float:
    """Contention-free latency estimate of a move (list-scheduling priority).

    Intra-bank moves use the single-bank model on the raw ids (identical
    floats to ``core.scheduler``); cross-bank moves sum the routed plan per
    destination bank plus any intra-bank fan-out at the destination.
    """
    src = t.src % geom.total_pes
    dsts = tuple(d % geom.total_pes for d in _dsts(t))
    src_bank = geom.bank_of(src)
    if all(geom.bank_of(d) == src_bank for d in dsts):
        return _move_latency(mode, t.src, _dsts(t), t.rows)
    total = 0.0
    for bank, group in _split_by_bank(geom, dsts).items():
        if bank == src_bank:
            total += _move_latency(mode, src, tuple(group), t.rows)
            continue
        p = xbar.plan(mode, geom, src, group[0])
        total += p.total_ns(t.rows)
        if len(group) > 1:
            # fan out from the bank port to the remaining destinations
            total += _move_latency(mode, bank * geom.pes_per_bank,
                                   tuple(group[1:]), t.rows)
    return total


def _critical_path(tasks: dict[int, Task], succ: dict[int, list[int]],
                   mode: Interconnect, geom: DeviceGeometry
                   ) -> dict[int, float]:
    order = _topo_order(tasks, succ)
    cp: dict[int, float] = {}
    for uid in reversed(order):
        t = tasks[uid]
        dur = t.duration if t.kind == "op" \
            else _device_move_latency(mode, geom, t)
        cp[uid] = dur + max((cp[s] for s in succ.get(uid, ())), default=0.0)
    return cp


def schedule(tasks_in: Iterable[Task], mode: Interconnect,
             geometry: DeviceGeometry = SINGLE_BANK) -> DeviceScheduleResult:
    """List-schedule a global-PE task graph on the whole device."""
    geom = geometry
    tasks = {t.uid: t for t in tasks_in}
    succ: dict[int, list[int]] = {}
    for t in tasks.values():
        for d in t.deps:
            succ.setdefault(d, []).append(t.uid)
    cp = _critical_path(tasks, succ, mode, geom)

    dev = _DeviceState(geom)
    finish: dict[int, float] = {}
    indeg = {uid: len(t.deps) for uid, t in tasks.items()}
    ready: list[tuple[float, float, int]] = []
    for uid, d in indeg.items():
        if d == 0:
            heapq.heappush(ready, (-cp[uid], 0.0, uid))

    op_busy = move_busy = stall = 0.0
    n_ops = n_moves = n_rows = n_cross = 0
    energy = 0.0
    rows_by_route: dict[str, int] = {}
    bus_busy = {"bank_group": 0.0, "channel": 0.0}
    e_move_row = (pluto.E_MOVE_LISA if mode is Interconnect.LISA
                  else pluto.E_MOVE_BUS)

    def lisa_span_start(bank: Bank, lo: int, hi: int, floor: float) -> float:
        return max(floor, *(bank.pe_free[p] for p in range(lo, hi + 1)))

    def lisa_span_hold(bank: Bank, lo: int, hi: int, start: float,
                       end: float) -> float:
        # start is already >= every pe_free in the span (the caller floors
        # at lisa_span_start), so each PE's hold equals the full span
        s = (hi - lo + 1) * (end - start)
        for p in range(lo, hi + 1):
            bank.pe_free[p] = end
        return s

    while ready:
        _, ready_t, uid = heapq.heappop(ready)
        t = tasks[uid]
        dep_t = max((finish[d] for d in t.deps), default=0.0)
        if t.kind == "op":
            gpe = t.pe % geom.total_pes
            bank = dev.banks[geom.bank_of(gpe)]
            pe = geom.local_of(gpe)
            start = max(dep_t, bank.pe_free[pe])
            end = start + t.duration
            bank.pe_free[pe] = end
            op_busy += t.duration
            n_ops += 1
        elif t.kind == "move":
            gsrc = t.src % geom.total_pes
            gdsts = tuple(d % geom.total_pes for d in _dsts(t))
            src_bank_i = geom.bank_of(gsrc)
            src_bank = dev.banks[src_bank_i]
            src = geom.local_of(gsrc)
            if all(geom.bank_of(d) == src_bank_i for d in gdsts):
                # --- intra-bank: the exact single-bank engine -------------------
                dsts = tuple(geom.local_of(d) for d in gdsts)
                dur = _move_latency(mode, src, dsts, t.rows)
                if mode is Interconnect.LISA:
                    lo = min((src, *dsts))
                    hi = max((src, *dsts))
                    start = lisa_span_start(src_bank, lo, hi, dep_t)
                    end = start + dur
                    stall += lisa_span_hold(src_bank, lo, hi, start, end)
                else:
                    start = max(dep_t, src_bank.bus_free,
                                src_bank.tx_free[src],
                                *(src_bank.rx_free[d] for d in dsts))
                    end = start + dur
                    src_bank.bus_free = end
                    src_bank.tx_free[src] = end
                    for d in dsts:
                        src_bank.rx_free[d] = end
                move_busy += dur
                rows_by_route["intra"] = rows_by_route.get("intra", 0) \
                    + t.rows * len(gdsts)
            else:
                # --- cross-bank: route each destination bank ------------------
                end = dep_t
                for bank_i, group in _split_by_bank(geom, gdsts).items():
                    dsts = tuple(geom.local_of(d) for d in group)
                    if bank_i == src_bank_i:
                        dur = _move_latency(mode, src, dsts, t.rows)
                        if mode is Interconnect.LISA:
                            lo, hi = min((src, *dsts)), max((src, *dsts))
                            s0 = lisa_span_start(src_bank, lo, hi, dep_t)
                            e0 = s0 + dur
                            stall += lisa_span_hold(src_bank, lo, hi, s0, e0)
                        else:
                            s0 = max(dep_t, src_bank.bus_free,
                                     src_bank.tx_free[src],
                                     *(src_bank.rx_free[d] for d in dsts))
                            e0 = s0 + dur
                            src_bank.bus_free = e0
                            src_bank.tx_free[src] = e0
                            for d in dsts:
                                src_bank.rx_free[d] = e0
                        move_busy += dur
                        rows_by_route["intra"] = \
                            rows_by_route.get("intra", 0) + t.rows * len(dsts)
                        end = max(end, e0)
                        continue
                    dst_bank = dev.banks[bank_i]
                    route = geom.route(src_bank_i, bank_i)
                    p = xbar.plan(mode, geom, gsrc, group[0])
                    gbuses, cbuses = _transit_resources(
                        geom, src_bank_i, bank_i, route)
                    # fan-out from the bank port to every destination in the
                    # bank rides the intra-bank interconnect
                    fill = _move_latency(mode, 0, dsts, t.rows)
                    if mode is Interconnect.LISA:
                        # circuit-switched: spans + all buses, end-to-end
                        dur = t.rows * (p.drain_ns + p.transit_ns) + fill
                        s_lo, s_hi = 0, src
                        d_lo, d_hi = 0, max(dsts)
                        s0 = max(dep_t,
                                 lisa_span_start(src_bank, s_lo, s_hi, dep_t),
                                 lisa_span_start(dst_bank, d_lo, d_hi, dep_t),
                                 *(dev.group_bus_free[g] for g in gbuses),
                                 *(dev.chan_bus_free[c] for c in cbuses))
                        e0 = s0 + dur
                        stall += lisa_span_hold(src_bank, s_lo, s_hi, s0, e0)
                        stall += lisa_span_hold(dst_bank, d_lo, d_hi, s0, e0)
                        for g in gbuses:
                            bus_busy["bank_group"] += e0 - s0
                            dev.group_bus_free[g] = e0
                        for c in cbuses:
                            bus_busy["channel"] += e0 - s0
                            dev.chan_bus_free[c] = e0
                        move_busy += dur
                    else:
                        # store-and-forward: each leg holds only its window
                        drain = t.rows * p.drain_ns
                        transit = t.rows * p.transit_ns
                        s1 = max(dep_t, src_bank.bus_free,
                                 src_bank.tx_free[src])
                        e1 = s1 + drain
                        src_bank.bus_free = e1
                        src_bank.tx_free[src] = e1
                        s2 = max(s1 + p.drain_ns,
                                 *(dev.group_bus_free[g] for g in gbuses),
                                 *(dev.chan_bus_free[c] for c in cbuses))
                        e2 = s2 + transit
                        for g in gbuses:
                            bus_busy["bank_group"] += transit
                            dev.group_bus_free[g] = e2
                        for c in cbuses:
                            bus_busy["channel"] += transit
                            dev.chan_bus_free[c] = e2
                        s3 = max(s2 + p.transit_ns, dst_bank.bus_free,
                                 *(dst_bank.rx_free[d] for d in dsts))
                        e0 = max(s3 + fill, e2 + p.fill_ns)
                        dst_bank.bus_free = e0
                        for d in dsts:
                            dst_bank.rx_free[d] = e0
                        move_busy += drain + transit + fill
                    # drain + transit priced by the routed plan; the fill
                    # fan-out is priced at the flat per-row coefficient with
                    # every other delivery, in one multiply at the end
                    energy += t.rows * (p.drain_energy_j + p.transit_energy_j)
                    rows_by_route[route] = rows_by_route.get(route, 0) \
                        + t.rows * len(dsts)
                    end = max(end, e0)
                n_cross += 1
            n_moves += 1
            n_rows += t.rows * len(gdsts)
        else:
            raise ValueError(f"unknown task kind {t.kind!r}")

        finish[uid] = end
        for s in succ.get(uid, ()):
            indeg[s] -= 1
            if indeg[s] == 0:
                heapq.heappush(ready, (-cp[s], end, s))

    if len(finish) != len(tasks):
        raise ValueError("scheduler deadlock: not all tasks executed")
    makespan = max(finish.values(), default=0.0)
    # one flat per-row delivery charge across all routes (single multiply so
    # a 1-bank device reproduces ScheduleResult.transfer_energy_j bit-for-bit)
    energy += sum(rows_by_route.values()) * e_move_row
    return DeviceScheduleResult(
        mode, geom, makespan, op_busy, move_busy, stall, n_ops, n_moves,
        n_rows, finish, energy, n_cross, rows_by_route, bus_busy)


# --- legacy per-config graph composition ----------------------------------------
# The pre-refactor ``build_partitioned`` built Task-object graphs and applied
# placements with one ``dataclasses.replace`` per task; preserved here so the
# sweep baseline pays the same per-config construction cost the original
# per-config loop paid.


def _sinks(tasks: Sequence[Task]) -> tuple[int, ...]:
    used = {d for t in tasks for d in t.deps}
    return tuple(t.uid for t in tasks if t.uid not in used)


def _offset(tasks: Sequence[Task], uid_off: int, pe_off: int) -> list[Task]:
    out = []
    for t in tasks:
        out.append(dataclasses.replace(
            t, uid=t.uid + uid_off,
            deps=tuple(d + uid_off for d in t.deps),
            pe=None if t.pe is None else t.pe + pe_off,
            src=None if t.src is None else t.src + pe_off,
            dst=None if t.dst is None else (
                tuple(d + pe_off for d in t.dst) if isinstance(t.dst, tuple)
                else t.dst + pe_off)))
    return out


def build_partitioned(app: str, mode: Interconnect, geom: DeviceGeometry,
                      policy: str = "locality_first",
                      scaling: str = "strong", **kw) -> list[Task]:
    """Legacy task-object equivalent of ``partition.build_partitioned``.

    Graphs come from the preserved legacy builders
    (:func:`repro_torch.core.reference.build`), not the IR-backed live ones, so
    the baseline's construction cost matches the pre-refactor loop's.
    """
    if scaling == "strong":
        if app in ("bfs", "dfs"):
            kw.setdefault("n_stripes", geom.n_banks)
        tasks = core_reference.build(app, mode, n_pes=geom.total_pes, **kw)
        return _remap(tasks, pe_map(geom, policy, tasks))
    if scaling != "weak":
        raise ValueError(f"scaling must be 'weak' or 'strong', got {scaling!r}")

    ppb = geom.pes_per_bank
    all_tasks: list[Task] = []
    agg_pe = 1 % ppb            # bank-0 aggregator subarray
    t_add = pluto.op32_latency_ns("add", mode)
    prev_red: int | None = None
    for b in range(geom.n_banks):
        replica = core_reference.build(app, mode, n_pes=ppb, **kw)
        replica = _offset(replica, uid_off=len(all_tasks), pe_off=b * ppb)
        sinks = _sinks(replica)
        all_tasks.extend(replica)
        if b == 0:
            continue
        # result hand-off: one 32-bit row-vector of partials per replica
        mv = Task(len(all_tasks), "move", deps=sinks, src=b * ppb + agg_pe,
                  dst=agg_pe, rows=taskgraph.SLICES_32, tag=f"reduce.mv b{b}")
        all_tasks.append(mv)
        red = Task(len(all_tasks), "op",
                   deps=(mv.uid,) if prev_red is None
                   else (mv.uid, prev_red),
                   pe=agg_pe, duration=t_add, tag=f"reduce.add b{b}")
        all_tasks.append(red)
        prev_red = red.uid
    return all_tasks
