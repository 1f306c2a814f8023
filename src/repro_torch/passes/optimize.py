"""Post-placement move optimization passes (PyTorch port of
``repro/passes/optimize.py``).

These passes exploit what only the placed graph knows — which physical PE
every endpoint landed on — to delete, merge, and shorten data movement.
They rewrite the *graph*, never the engine: the resource models price the
optimized moves with exactly the machinery they price hand-written ones
(Shared-PIM's broadcast amortization and store-and-forward legs, LISA's
distance-priced spans), so the measured advantage is a compiler effect,
not a cost-model special case.

* :class:`SelfMoveEliminationPass` — a move whose destinations all equal
  its source carries data nowhere; it is deleted and its dependents are
  rewired onto its dependencies through the CSR.
* :class:`BroadcastCoalescePass` — N moves carrying the *same* value (same
  source PE, same dependency set, same row count) to different consumers
  collapse into one broadcast move over the union of destinations.
  Shared-PIM prices each extra pipelined destination at ``t_overlap``
  (4 ns) instead of a full 52.75 ns bus transaction, so this directly
  widens the Shared-PIM/LISA gap on operand fan-out (model matmul operand
  hand-offs, MoE expert routing).
* :class:`MoveFusionPass` — a store-and-forward chain ``A -> B -> C`` whose
  intermediate copy has no other reader merges into the single move
  ``A -> C``: one drain/transit/fill instead of two, and under LISA a span
  no longer than the two legs combined (``|A-C| <= |A-B| + |B-C|``).

Every pass is a pure ``TaskGraph -> TaskGraph`` function, returns its input
unchanged when nothing matches (idempotence), and records one
:class:`~repro_torch.passes.pipeline.Rewrite` per removed task.

The passes read a graph's host tensors as Python lists once and match on
Python ints, so every decision, rewrite and log entry is the reference's.
"""

from __future__ import annotations

import torch

from repro_torch.core.ir import MOVE, TaskGraph
from repro_torch.passes.pipeline import Pass, RewriteLog, Rewrite
from repro_torch.passes.rewrite import rebuild


class SelfMoveEliminationPass(Pass):
    """Delete moves whose source and every destination are the same PE."""

    name = "self_move_elim"
    stage = "optimize"

    def run(self, g: TaskGraph, log: RewriteLog) -> TaskGraph:
        drop: list[int] = []
        dep_subst: dict[int, tuple[int, ...]] = {}
        src = g.src.tolist()
        dst_flat, dst_indptr = g.dst_flat.tolist(), g.dst_indptr.tolist()
        dep_pos, dep_indptr = g.dep_pos.tolist(), g.dep_indptr.tolist()
        for i in _moves(g):
            dsts = dst_flat[dst_indptr[i]:dst_indptr[i + 1]]
            if len(dsts) and all(d == src[i] for d in dsts):
                drop.append(i)
                dep_subst[i] = tuple(dep_pos[dep_indptr[i]:dep_indptr[i + 1]])
        if not drop:
            return g
        uids = g.uids.tolist()
        for i in drop:
            log.add(Rewrite(self.name, "eliminate", uids[i],
                            detail=f"src == dst == PE {src[i]}"))
        return rebuild(g, drop=drop, dep_subst=dep_subst)


class BroadcastCoalescePass(Pass):
    """Merge same-value hand-offs into per-destination-bank broadcasts.

    Two moves carry the same value exactly when they leave the same source
    PE with the same dependency set and the same row count.  Merging them
    blindly would be wrong-headed, though: a consumer of the merged move
    waits for *every* destination, so gluing hand-offs bound for different
    banks together trades cross-bank pipelining for a longer combined move.
    The pass is therefore **hop aware** — only hand-offs bound for the same
    destination bank coalesce (``pes_per_bank`` defines banks; ``None``
    treats the whole PE space as one bank, the single-bank scheduler's
    view).  Within a bank the trade is strictly favorable under Shared-PIM:
    each extra pipelined broadcast destination costs ``t_overlap`` (4 ns)
    where a separate hand-off costs a full bus transaction (52.75 ns) —
    and every merged-away move frees a drain slot on the source bank's bus.

    Moves whose own destinations already span banks are left untouched
    (they are the frontend's deliberate broadcasts); the merged move keeps
    the earliest member's position/uid/tag, and dependents of merged-away
    moves are rewired onto it.
    """

    name = "coalesce_broadcasts"
    stage = "optimize"

    def __init__(self, pes_per_bank: int | None = None):
        self.pes_per_bank = pes_per_bank

    def describe(self) -> str:
        return self.name if self.pes_per_bank is None \
            else f"{self.name}[{self.pes_per_bank}ppb]"

    def _bank(self, pe: int) -> int:
        return 0 if self.pes_per_bank is None else pe // self.pes_per_bank

    def run(self, g: TaskGraph, log: RewriteLog) -> TaskGraph:
        src, rows = g.src.tolist(), g.rows.tolist()
        dst_flat, dst_indptr = g.dst_flat.tolist(), g.dst_indptr.tolist()
        dep_pos, dep_indptr = g.dep_pos.tolist(), g.dep_indptr.tolist()

        def dsts_of(i):
            return dst_flat[dst_indptr[i]:dst_indptr[i + 1]]

        groups: dict[tuple, list[int]] = {}
        for i in _moves(g):
            banks = {self._bank(d) for d in dsts_of(i)}
            if len(banks) != 1:
                continue        # an intentional cross-bank broadcast
            key = (src[i], tuple(sorted(dep_pos[dep_indptr[i]:
                                                dep_indptr[i + 1]])),
                   rows[i], banks.pop())
            groups.setdefault(key, []).append(i)

        drop: list[int] = []
        dep_subst: dict[int, tuple[int, ...]] = {}
        new_dsts: dict[int, tuple[int, ...]] = {}
        uids = g.uids.tolist()
        for (src_pe, _deps, _rows, bank), members in groups.items():
            if len(members) < 2:
                continue
            union = sorted({d for m in members for d in dsts_of(m)}
                           - {src_pe})
            if not union:
                continue        # pure self-moves: SelfMoveEliminationPass's job
            rep = members[0]
            new_dsts[rep] = tuple(union)
            for m in members[1:]:
                drop.append(m)
                dep_subst[m] = (rep,)
                log.add(Rewrite(
                    self.name, "coalesce", uids[m], into=uids[rep],
                    detail=f"{len(members)}-way broadcast "
                           f"PE {src_pe} -> bank {bank}"))
        if not drop:
            return g
        return rebuild(g, drop=drop, dep_subst=dep_subst, new_dsts=new_dsts)


class MoveFusionPass(Pass):
    """Fuse store-and-forward move chains into single multi-hop moves.

    A pair ``(first, second)`` fuses when the second move's *only*
    dependency is the first, the first's *only* dependent is the second,
    both are single-destination, the first delivers exactly where the
    second picks up, and the row counts match — i.e. the intermediate copy
    exists only to forward the value.  Chains of any length collapse onto
    their final move.  A chain that returns to its origin (``A -> … -> A``)
    is deleted outright.
    """

    name = "fuse_moves"
    stage = "optimize"

    def run(self, g: TaskGraph, log: RewriteLog) -> TaskGraph:
        n_deps = torch.diff(g.dep_indptr)
        n_dsts = torch.diff(g.dst_indptr)
        succ_indptr, _succ_flat = g.successors()
        n_succ = torch.diff(succ_indptr).tolist()
        is_move = g.kinds == MOVE
        single_t = is_move & (n_dsts == 1)
        single = single_t.tolist()
        src, rows = g.src.tolist(), g.rows.tolist()
        dst_flat, dst_indptr = g.dst_flat.tolist(), g.dst_indptr.tolist()
        dep_pos, dep_indptr = g.dep_pos.tolist(), g.dep_indptr.tolist()

        # second -> first links of fusable pairs
        pred: dict[int, int] = {}
        for i in torch.nonzero(single_t & (n_deps == 1)).flatten().tolist():
            d = dep_pos[dep_indptr[i]]
            if (single[d] and n_succ[d] == 1
                    and dst_flat[dst_indptr[d]] == src[i]
                    and rows[d] == rows[i]):
                pred[i] = d

        if not pred:
            return g
        uids = g.uids.tolist()
        firsts = set(pred.values())
        drop: list[int] = []
        dep_subst: dict[int, tuple[int, ...]] = {}
        new_src: dict[int, int] = {}
        new_deps: dict[int, tuple[int, ...]] = {}
        for tail in pred:
            if tail in firsts:
                continue        # not the end of its chain
            chain = [pred[tail]]
            while chain[-1] in pred:
                chain.append(pred[chain[-1]])
            head = chain[-1]
            legs = len(chain) + 1
            head_src = src[head]
            head_deps = tuple(dep_pos[dep_indptr[head]:dep_indptr[head + 1]])
            round_trip = head_src == dst_flat[dst_indptr[tail]]
            # drop every link before the tail, rewiring onto the tail
            for link in chain:
                drop.append(link)
                dep_subst[link] = (tail,)
                if not round_trip:
                    log.add(Rewrite(
                        self.name, "fuse", uids[link], into=uids[tail],
                        detail=f"{legs}-leg chain -> single move"))
            if round_trip:
                # the chain delivers back to its origin: it is all dead
                drop.append(tail)
                dep_subst[tail] = head_deps
                for link in (*chain, tail):
                    log.add(Rewrite(
                        self.name, "eliminate", uids[link],
                        detail=f"{legs}-leg chain returns to PE {head_src}"))
                continue
            new_src[tail] = head_src
            new_deps[tail] = head_deps
        return rebuild(g, drop=drop, dep_subst=dep_subst, new_src=new_src,
                       new_deps=new_deps)


def _moves(g: TaskGraph) -> list[int]:
    """Positions of the graph's moves, in order."""
    return torch.nonzero(g.kinds == MOVE).flatten().tolist()


#: registry of optimization passes addressable by name (sweep configs,
#: serving runtimes, and benchmark CLIs select passes by these keys); each
#: factory takes the target's PEs-per-bank (None = one-bank PE space)
OPT_PASSES = {
    SelfMoveEliminationPass.name:
        lambda pes_per_bank=None: SelfMoveEliminationPass(),
    BroadcastCoalescePass.name:
        lambda pes_per_bank=None: BroadcastCoalescePass(pes_per_bank),
    MoveFusionPass.name:
        lambda pes_per_bank=None: MoveFusionPass(),
}

#: the standard optimization stage, in its canonical order
DEFAULT_OPT = (SelfMoveEliminationPass.name, BroadcastCoalescePass.name,
               MoveFusionPass.name)
