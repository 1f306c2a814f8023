"""Workload partitioning: splitting task graphs across the device's banks
(PyTorch port of ``repro/device/partition.py``).

The taskgraph builders (:mod:`repro_torch.core.taskgraph`) emit graphs over a
flat *virtual* PE space of any size.  This module decides which physical bank
each virtual PE lands on — the placement determines how much traffic crosses
bank boundaries, which is exactly the axis along which Shared-PIM and LISA
diverge at device scale.

Placement policies (``place``):

* ``round_robin``      — virtual PE ``v`` -> bank ``v % n_banks``.  Maximal
  scatter: nearly every producer/consumer pair straddles banks.  The
  stress-test upper bound for cross-bank traffic.
* ``locality_first``   — contiguous blocks: virtual PE ``v`` -> bank
  ``v // pes_per_bank`` (identity on global ids).  What a locality-aware
  compiler would emit; only block-boundary neighbors communicate across
  banks.
* ``bandwidth_balanced`` — locality blocks, but blocks are ranked by their
  cross-block traffic (row-weighted) and the heaviest blocks are spread
  round-robin across channels, then bank groups, so no single bank-group bus
  or channel carries a disproportionate share of the transit load.

``build_partitioned`` is the one-call entry point: it builds an app over the
right virtual PE count for the geometry (``strong`` scaling: one
fixed-size problem over all banks; ``weak``: one bank-sized replica per bank
plus a cross-bank reduction onto bank 0) and applies a policy.

Placement runs as a stage of the :mod:`repro_torch.passes` pipeline: the app
builders emit *logical* graphs on virtual PEs, and
``validate -> place -> legalize`` turns them physical (the policies below
are what the place stage applies).  :func:`optimized_struct` additionally
runs the optimization stage — self-move elimination, broadcast coalescing,
move fusion — and memoizes the optimized artifact per pipeline
configuration, so sweeps pay for each (cell, pipeline) combination once.
With no optimization passes the pipeline is **off** and the placed graph is
bit-for-bit the pre-pipeline one (golden schedules assert this).

Placement and composition are **mode independent** (only op durations vary with
the interconnect), so the placed graph for one (app, geometry, policy, scaling,
problem-size) cell is built once as a structural
:class:`~repro_torch.core.ir.TaskGraph` (``functools.lru_cache``) and
materialized per mode — the fast path
:class:`repro_torch.device.batch.BatchRunner` sweeps over.  The legacy
``list[Task]`` API is preserved as converting wrappers routed through the same
IR remap (:func:`_remap_ir`), so placement logic exists exactly once.

Graphs are host tensors and stay on the host here: the traffic weights,
the remaps and the replica concatenation are tensor operations on the CPU
(integer row counts, so the float sums of the weights are exact), and the
placed graphs are memoized as in the reference.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import torch

from repro_torch import passes as passlib
from repro_torch.core import ir, taskgraph
from repro_torch.core.ir import MOVE, NONE_SENTINEL, TaskGraph
from repro_torch.core.pluto import Interconnect
from repro_torch.device.geometry import DeviceGeometry

POLICIES = ("round_robin", "locality_first", "bandwidth_balanced")

_I64 = torch.int64


# --- placement maps -------------------------------------------------------------


def _block_weights(tasks, geom: DeviceGeometry) -> list[float]:
    """Cross-block row traffic incident to each contiguous virtual block."""
    if isinstance(tasks, TaskGraph):
        return _block_weights_ir(tasks, geom)
    # legacy task lists convert to the IR so the weighting exists once;
    # integer row counts sum exactly in float64, so the result is identical
    return _block_weights_ir(ir.from_tasks(tasks), geom)


def _block_weights_ir(g: TaskGraph, geom: DeviceGeometry) -> list[float]:
    """Vectorized :func:`_block_weights` (exact: integer row counts)."""
    ppb, total = geom.pes_per_bank, geom.total_pes
    moves = g.kinds == MOVE
    counts = torch.diff(g.dst_indptr)
    src_blk = torch.repeat_interleave((g.src % total) // ppb, counts)
    rows = torch.repeat_interleave(torch.where(moves, g.rows, 0), counts)
    dst_blk = (g.dst_flat % total) // ppb
    cross = src_blk != dst_blk
    weights = rows[cross].to(torch.float64)
    w = torch.bincount(src_blk[cross], weights=weights,
                       minlength=geom.n_banks).to(torch.float64)
    w += torch.bincount(dst_blk[cross], weights=weights,
                        minlength=geom.n_banks)
    return w.tolist()


def _spread_bank_order(geom: DeviceGeometry) -> list[int]:
    """Banks ordered so consecutive picks land on different devices/channels."""
    by_pos: list[int] = []
    for pos in range(geom.banks_per_group):
        for g in range(geom.bank_groups_per_channel):
            for ch in range(geom.channels):
                for dev in range(geom.devices):
                    by_pos.append((dev * geom.channels + ch)
                                  * geom.banks_per_channel
                                  + g * geom.banks_per_group + pos)
    return by_pos


def pe_map(geom: DeviceGeometry, policy: str,
           tasks=None) -> list[int]:
    """virtual PE id -> global PE id, one entry per PE of the device.

    ``tasks`` (a legacy task list or a :class:`TaskGraph`) is only needed by
    the traffic-weighted ``bandwidth_balanced`` policy.
    """
    ppb, nb = geom.pes_per_bank, geom.n_banks
    if policy == "locality_first":
        return list(range(geom.total_pes))
    if policy == "round_robin":
        return [(v % nb) * ppb + (v // nb) % ppb
                for v in range(geom.total_pes)]
    if policy == "bandwidth_balanced":
        if tasks is None:
            raise ValueError("bandwidth_balanced placement needs the task "
                             "graph to weigh block traffic")
        weights = _block_weights(tasks, geom)
        order = _spread_bank_order(geom)
        # heaviest communicating block -> next bank in the channel-spread
        # order (stable on ties, so the policy is deterministic)
        ranked = sorted(range(nb), key=lambda b: (-weights[b], b))
        assign = {blk: order[i] for i, blk in enumerate(ranked)}
        return [assign[v // ppb] * ppb + v % ppb
                for v in range(geom.total_pes)]
    raise ValueError(f"unknown policy {policy!r}; pick one of {POLICIES}")


# --- applying a placement -------------------------------------------------------


def _remap_ir(g: TaskGraph, m: torch.Tensor) -> TaskGraph:
    """Apply a virtual-PE -> global-PE map to every pe/src/dst array."""
    pe = torch.where(g.pe == NONE_SENTINEL, NONE_SENTINEL,
                     m[torch.where(g.pe == NONE_SENTINEL, 0, g.pe)])
    src = torch.where(g.src == NONE_SENTINEL, NONE_SENTINEL,
                      m[torch.where(g.src == NONE_SENTINEL, 0, g.src)])
    return dataclasses.replace(g, pe=pe, src=src, dst_flat=m[g.dst_flat])


def place_ir(g: TaskGraph, geom: DeviceGeometry,
             policy: str = "locality_first") -> TaskGraph:
    """Vectorized placement: remap every pe/src/dst array through the map."""
    return _remap_ir(g, torch.tensor(pe_map(geom, policy, g),
                                     dtype=torch.int64))


# --- bank-set leases (the serving runtime's dynamic tenancy) --------------------


def lease_pe_map(geom: DeviceGeometry, banks: Sequence[int],
                 policy: str = "locality_first",
                 tasks=None) -> list[int]:
    """Virtual PE id -> global PE id for a job leased the given bank set.

    A leased job's graph addresses a *virtual device* of ``len(banks)``
    banks; the ordinary placement policies apply within the lease (virtual
    bank ``i`` is ``banks[i]``), so online tenants inherit exactly the
    placement semantics the offline partitioner uses.  ``tasks`` feeds the
    traffic-weighted ``bandwidth_balanced`` policy, as in :func:`pe_map`.
    """
    banks = list(banks)
    if not banks:
        raise ValueError("a lease needs at least one bank")
    seen: set[int] = set()
    dups: set[int] = set()
    for b in banks:
        (dups if b in seen else seen).add(b)
    if dups:
        raise ValueError(
            f"duplicate banks in lease: {sorted(dups)} (lease was {banks})")
    bad = sorted({b for b in banks if not 0 <= b < geom.n_banks})
    if bad:
        raise ValueError(
            f"banks {bad} out of range [0, {geom.n_banks}) "
            f"for {geom.describe()}")
    ppb = geom.pes_per_bank
    sub = DeviceGeometry(channels=1, banks_per_channel=len(banks),
                         pes_per_bank=ppb)
    return [banks[p // ppb] * ppb + p % ppb
            for p in pe_map(sub, policy, tasks)]


def place_on_banks(g: TaskGraph, geom: DeviceGeometry, banks: Sequence[int],
                   policy: str = "locality_first") -> TaskGraph:
    """Remap a virtual-PE task graph onto a leased bank set (vectorized)."""
    m = torch.tensor(lease_pe_map(geom, banks, policy, g), dtype=torch.int64)
    return _remap_ir(g, m)


def place(tasks, geom: DeviceGeometry,
          policy: str = "locality_first"):
    """Remap a virtual-PE task graph onto physical banks under a policy.

    Accepts and returns either representation: a legacy task list yields a
    task list, a :class:`TaskGraph` yields a placed :class:`TaskGraph`.
    Both routes apply the same IR remap (:func:`_remap_ir`) — the legacy
    path converts through :mod:`repro_torch.core.ir` rather than keeping a twin
    per-Task implementation.
    """
    if isinstance(tasks, TaskGraph):
        return place_ir(tasks, geom, policy)
    g = ir.from_tasks(tasks)
    return ir.to_tasks(place_ir(g, geom, policy))


def cross_traffic_rows(tasks, geom: DeviceGeometry) -> int:
    """Row deliveries whose endpoints sit in different banks (diagnostic)."""
    g = tasks if isinstance(tasks, TaskGraph) else ir.from_tasks(tasks)
    counts = torch.diff(g.dst_indptr)
    src_bank = torch.repeat_interleave((g.src % geom.total_pes)
                                       // geom.pes_per_bank, counts)
    rows = torch.repeat_interleave(torch.where(g.kinds == MOVE, g.rows, 0),
                                   counts)
    dst_bank = (g.dst_flat % geom.total_pes) // geom.pes_per_bank
    return int(rows[src_bank != dst_bank].sum())


# --- partitioned app composition ------------------------------------------------


def _sinks(g: TaskGraph) -> tuple[int, ...]:
    """Positions no task depends on, ascending."""
    sink = torch.ones(g.n, dtype=torch.bool)
    sink[g.dep_pos] = False
    return tuple(torch.nonzero(sink).flatten().tolist())


@functools.lru_cache(maxsize=None)
def _partitioned_struct(app: str, geom: DeviceGeometry, policy: str,
                        scaling: str, kw_items: tuple) -> TaskGraph:
    kw = dict(kw_items)
    if scaling == "strong":
        if app in ("bfs", "dfs"):
            kw.setdefault("n_stripes", geom.n_banks)
        g = taskgraph.structural(app, n_pes=geom.total_pes, **kw)
        # the logical graph turns physical through the pass pipeline with
        # no optimization stage (pipeline off == the pre-pipeline placement)
        placed, _log = passlib.device_pipeline(geom, policy).run(g)
        return ir.freeze(placed)
    if scaling != "weak":
        raise ValueError(f"scaling must be 'weak' or 'strong', got {scaling!r}")

    ppb = geom.pes_per_bank
    rep = taskgraph.structural(app, n_pes=ppb, **kw)
    sinks = _sinks(rep)
    agg_pe = 1 % ppb            # bank-0 aggregator subarray
    add_cls = ir.OP_CLASSES.index("add")

    b = _ReplicaConcat(rep)
    prev_red: int | None = None
    for bank in range(geom.n_banks):
        off = b.append_replica(pe_off=bank * ppb)
        if bank == 0:
            continue
        # result hand-off: one 32-bit row-vector of partials per replica
        mv = b.append_move(src=bank * ppb + agg_pe, dst=agg_pe,
                           deps=tuple(s + off for s in sinks),
                           rows=taskgraph.SLICES_32, tag=f"reduce.mv b{bank}")
        red = b.append_op(pe=agg_pe, op_class=add_cls,
                          deps=(mv,) if prev_red is None else (mv, prev_red),
                          tag=f"reduce.add b{bank}")
        prev_red = red
    return b.build()


class _ReplicaConcat:
    """Array-level concatenation of per-bank replicas plus reduction tasks."""

    def __init__(self, rep: TaskGraph):
        self.rep = rep
        self.chunks: list[dict] = []
        self.count = 0

    def append_replica(self, pe_off: int) -> int:
        rep = self.rep
        off = self.count
        self.chunks.append(dict(
            kinds=rep.kinds,
            dep_counts=torch.diff(rep.dep_indptr),
            dep_pos=rep.dep_pos + off,
            duration=rep.duration,
            op_class=rep.op_class,
            pe=torch.where(rep.pe == NONE_SENTINEL, NONE_SENTINEL,
                           rep.pe + pe_off),
            src=torch.where(rep.src == NONE_SENTINEL, NONE_SENTINEL,
                            rep.src + pe_off),
            dst_counts=torch.diff(rep.dst_indptr),
            dst_flat=rep.dst_flat + pe_off,
            dst_is_tuple=rep.dst_is_tuple,
            rows=rep.rows,
            tags=rep.tags if rep.tags is not None else ("",) * rep.n,
        ))
        self.count += rep.n
        return off

    def _append_one(self, **fields) -> int:
        uid = self.count
        self.chunks.append(fields)
        self.count += 1
        return uid

    def append_move(self, src: int, dst: int, deps: tuple, rows: int,
                    tag: str) -> int:
        return self._append_one(
            kinds=torch.tensor([ir.MOVE], dtype=torch.int8),
            dep_counts=torch.tensor([len(deps)], dtype=_I64),
            dep_pos=torch.tensor(deps, dtype=_I64),
            duration=torch.zeros(1, dtype=torch.float64),
            op_class=torch.tensor([-1], dtype=torch.int16),
            pe=torch.tensor([NONE_SENTINEL], dtype=_I64),
            src=torch.tensor([src], dtype=_I64),
            dst_counts=torch.tensor([1], dtype=_I64),
            dst_flat=torch.tensor([dst], dtype=_I64),
            dst_is_tuple=torch.tensor([False]),
            rows=torch.tensor([rows], dtype=_I64),
            tags=(tag,))

    def append_op(self, pe: int, op_class: int, deps: tuple,
                  tag: str) -> int:
        return self._append_one(
            kinds=torch.tensor([ir.OP], dtype=torch.int8),
            dep_counts=torch.tensor([len(deps)], dtype=_I64),
            dep_pos=torch.tensor(deps, dtype=_I64),
            duration=torch.zeros(1, dtype=torch.float64),
            op_class=torch.tensor([op_class], dtype=torch.int16),
            pe=torch.tensor([pe], dtype=_I64),
            src=torch.tensor([NONE_SENTINEL], dtype=_I64),
            dst_counts=torch.tensor([0], dtype=_I64),
            dst_flat=torch.zeros(0, dtype=_I64),
            dst_is_tuple=torch.tensor([False]),
            rows=torch.tensor([1], dtype=_I64),
            tags=(tag,))

    def build(self) -> TaskGraph:
        def cat(key, dtype):
            arrs = [c[key] for c in self.chunks]
            return torch.cat(arrs).to(dtype) if arrs \
                else torch.zeros(0, dtype=dtype)

        dep_indptr = torch.zeros(self.count + 1, dtype=_I64)
        dep_indptr[1:] = torch.cumsum(cat("dep_counts", _I64), 0)
        dst_indptr = torch.zeros(self.count + 1, dtype=_I64)
        dst_indptr[1:] = torch.cumsum(cat("dst_counts", _I64), 0)
        tags = tuple(t for c in self.chunks for t in c["tags"])
        return ir.freeze(TaskGraph(
            uids=torch.arange(self.count, dtype=_I64),
            kinds=cat("kinds", torch.int8),
            dep_indptr=dep_indptr,
            dep_pos=cat("dep_pos", _I64),
            duration=cat("duration", torch.float64),
            op_class=cat("op_class", torch.int16),
            pe=cat("pe", _I64),
            src=cat("src", _I64),
            dst_indptr=dst_indptr,
            dst_flat=cat("dst_flat", _I64),
            dst_is_tuple=cat("dst_is_tuple", torch.bool),
            rows=cat("rows", _I64),
            tags=tags))


def partitioned_struct(app: str, geom: DeviceGeometry,
                       policy: str = "locality_first",
                       scaling: str = "strong", **kw) -> TaskGraph:
    """Memoized mode-independent placed graph for one sweep cell."""
    return _partitioned_struct(app, geom, policy, scaling,
                               tuple(sorted(kw.items())))


def _cell_pipeline(geom: DeviceGeometry, opt: tuple) -> "passlib.Pipeline":
    return passlib.optimization_pipeline(opt, pes_per_bank=geom.pes_per_bank,
                                         total_pes=geom.total_pes)


@functools.lru_cache(maxsize=None)
def _optimized_struct(app: str, geom: DeviceGeometry, policy: str,
                      scaling: str, opt: tuple, fingerprint: str,
                      kw_items: tuple):
    base = _partitioned_struct(app, geom, policy, scaling, kw_items)
    g, log = _cell_pipeline(geom, opt).run(base)
    return ir.freeze(g), log


def optimized_struct(app: str, geom: DeviceGeometry,
                     policy: str = "locality_first",
                     scaling: str = "strong",
                     opt: Sequence[str] = passlib.DEFAULT_OPT,
                     **kw) -> TaskGraph:
    """Pass-optimized placed graph for one sweep cell (memoized).

    Runs the :mod:`repro_torch.passes` optimization stage (``opt`` names the
    passes; ``()`` returns the placed graph unchanged) on top of the cached
    placement artifact, memoized per (cell, pipeline) — the pipeline's
    fingerprint (digesting each pass's full configuration, not just its
    name) is part of the cache key, so two sweeps sharing a pipeline share
    the optimized artifact and differently-configured pipelines never do.
    """
    opt = tuple(opt)
    return _optimized_struct(app, geom, policy, scaling, opt,
                             _cell_pipeline(geom, opt).fingerprint(),
                             tuple(sorted(kw.items())))[0]


def optimization_log(app: str, geom: DeviceGeometry,
                     policy: str = "locality_first",
                     scaling: str = "strong",
                     opt: Sequence[str] = passlib.DEFAULT_OPT,
                     **kw) -> passlib.RewriteLog:
    """The rewrite log behind :func:`optimized_struct` for the same cell."""
    opt = tuple(opt)
    return _optimized_struct(app, geom, policy, scaling, opt,
                             _cell_pipeline(geom, opt).fingerprint(),
                             tuple(sorted(kw.items())))[1]


def build_partitioned_ir(app: str, mode: Interconnect, geom: DeviceGeometry,
                         policy: str = "locality_first",
                         scaling: str = "strong", **kw) -> TaskGraph:
    """IR fast path of :func:`build_partitioned` (no Task objects)."""
    return ir.materialize(partitioned_struct(app, geom, policy, scaling,
                                             **kw), mode)


def build_partitioned(app: str, mode: Interconnect, geom: DeviceGeometry,
                      policy: str = "locality_first",
                      scaling: str = "strong", **kw) -> list:
    """Build one of the paper's apps split across every bank of the device.

    ``strong``: the problem keeps its size and its graph spans the whole
    device's virtual PE space; ``policy`` decides the bank placement.
    ``weak``: every bank runs its own bank-sized instance (problem grows
    with the device) and each replica streams its result slices to an
    aggregator on bank 0 — the cross-bank reduction every data-parallel
    deployment pays.  Replicas are bank-local by construction, so ``policy``
    only shapes the strong-scaling layout.
    """
    return ir.to_tasks(build_partitioned_ir(app, mode, geom, policy=policy,
                                            scaling=scaling, **kw))
