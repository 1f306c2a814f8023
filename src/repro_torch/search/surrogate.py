"""Admissible makespan lower bound — the search's pruning surrogate (PyTorch
port of ``repro/search/surrogate.py``).

**The oracle is the engine; the surrogate only prunes, never decides.**
Every makespan the search reports, compares, or returns comes from a full
discrete-event engine evaluation
(:func:`repro_torch.core.engine.oracle_makespan`).  This module's only job
is to answer, *very* cheaply, "could this candidate possibly beat the best
engine-verified makespan?" — and the answer may only ever be a safe "no".
That requires the bound to be **admissible**: ``lower_bound(m) <= `` the
true engine makespan for every placement ``m``
(``tests/test_torch_pim_search.py`` checks this against the engine).

Two resource-demand terms, each a true bound because every engine resource
is a single token (capacity one), so the makespan can never be smaller than
any single resource's total claimed time:

* **per-PE compute demand** — each op claims its PE for its full duration,
  so ``max_pe sum(durations)`` bounds the makespan.  Op durations and the
  op->PE multiset are placement-*permutation* invariant, so this term is a
  constant computed once.
* **per-bus transit demand** — every cross-bank row must ride its route's
  shared bus for at least the mode-independent transit leg
  (:func:`repro_torch.device.interconnect.transit_ns_per_row`); LISA's
  circuit-switched moves hold the bus strictly longer, Shared-PIM's
  store-and-forward holds it for exactly the leg.  Multi-destination moves
  are conservatively assumed to share one stream per bus (perfect
  broadcast), and routes beyond one hop are charged only the one leg that
  provably lands on the charged bus.  This is the placement-*dependent*
  term — it is what makes the bound discriminate between candidates.

The arithmetic runs on the graph's host tensors.  ``bincount`` adds its
weights in input order, and the first occurrence of each (move, bus) pair
is taken in ascending key order as ``numpy.unique`` takes it, so every
bound equals the reference's to the last bit (it decides which candidates
are pruned, hence the search's trajectory and counts).
"""

from __future__ import annotations

import torch

from repro_torch.core import timing as T
from repro_torch.core.ir import MOVE, NONE_SENTINEL, OP, TaskGraph
from repro_torch.device.geometry import DeviceGeometry

_I64 = torch.int64
_F64 = torch.float64


class LowerBoundModel:
    """Precomputed tensors for O(cross-pairs) lower bounds on one graph.

    Built once per :class:`~repro_torch.search.oracle.PlacementOracle` from
    the materialized *virtual* graph; :meth:`lower_bound` then evaluates any
    candidate virtual->global PE map without constructing the remapped
    graph.
    """

    def __init__(self, base: TaskGraph, geom: DeviceGeometry,
                 t: T.DramTiming = T.DDR3_1600):
        self.geom = geom
        self.ppb = geom.pes_per_bank
        self.n_groups = geom.n_groups
        self.n_buses = geom.n_groups + geom.n_channels
        self.grb_ns = t.grb_stream_ns
        self.chan_ns = t.channel_stream_ns

        ops = (base.kinds == OP) & (base.pe != NONE_SENTINEL)
        if bool(ops.any()):
            per_pe = torch.bincount(base.pe[ops],
                                    weights=base.duration[ops].to(_F64))
            self.op_lb = float(per_pe.max())
        else:
            self.op_lb = 0.0

        counts = torch.diff(base.dst_indptr)
        owners = torch.repeat_interleave(torch.arange(base.n, dtype=_I64),
                                         counts)
        pair_ok = (base.kinds[owners] == MOVE) \
            & (base.src[owners] != NONE_SENTINEL)
        self._move_id = owners[pair_ok]
        self._v_src = base.src[owners][pair_ok]
        self._v_dst = base.dst_flat[pair_ok]
        self._rows = base.rows[owners][pair_ok].to(_F64)

    # --- vectorized geometry arithmetic -----------------------------------------

    def _group_of(self, bank: torch.Tensor) -> torch.Tensor:
        g = self.geom
        ch = bank // g.banks_per_channel
        within = (bank % g.banks_per_channel) // g.banks_per_group
        return ch * g.bank_groups_per_channel + within

    # --- the bound --------------------------------------------------------------

    def lower_bound(self, m) -> float:
        """Admissible makespan lower bound of placement map ``m`` (ns)."""
        if self._v_src.numel() == 0:
            return self.op_lb
        m = torch.as_tensor(m, dtype=_I64)
        sb = m[self._v_src] // self.ppb
        db = m[self._v_dst] // self.ppb
        cross = sb != db
        if not bool(cross.any()):
            return self.op_lb
        sb, db = sb[cross], db[cross]
        same_group = self._group_of(sb) == self._group_of(db)
        # charged bus: the shared group bus for one-hop routes, else the
        # source channel I/O (the one leg every longer route provably pays)
        bus = torch.where(same_group, self._group_of(sb),
                          self.n_groups + sb // self.geom.banks_per_channel)
        cost = torch.where(same_group,
                           torch.tensor(self.grb_ns, dtype=_F64),
                           torch.tensor(self.chan_ns, dtype=_F64))
        # one stream per (move, bus): broadcast destinations on the same
        # bus may share a transit, so charge each such pair exactly once
        # (its first occurrence, in ascending key order)
        key = self._move_id[cross] * self.n_buses + bus
        uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
        first = torch.full((uniq.numel(),), key.numel(), dtype=_I64)
        first.scatter_reduce_(0, inv, torch.arange(key.numel(), dtype=_I64),
                              reduce="amin")
        demand = torch.bincount(bus[first],
                                weights=self._rows[cross][first]
                                * cost[first],
                                minlength=self.n_buses)
        return max(self.op_lb, float(demand.max()))
