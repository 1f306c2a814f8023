"""Structural graph surgery for the pass pipeline (PyTorch port of
``repro/passes/rewrite.py``).

Optimization passes delete and rewrite tasks of a structure-of-arrays
:class:`~repro_torch.core.ir.TaskGraph`.  Doing that by hand against the CSR
layout is error prone (every deletion shifts every later position), so the
passes describe their rewrite declaratively — *which* positions to drop,
what each dropped position's dependents should depend on instead, and any
per-task field overrides — and :func:`rebuild` applies the whole batch in
one pass over the arrays.

All positions are **old-space** (indices into the input graph); ``rebuild``
compacts them.  Kept tasks keep their original uids, so rewrite logs,
finish-time dicts and debug tags stay traceable across a whole pipeline.

``dep_subst`` entries may point at positions that are themselves dropped
(e.g. a chain of eliminated self-moves); substitutions are resolved
transitively.  Substituted dependency lists are deduplicated preserving
first-occurrence order, which keeps the output deterministic.

The arrays are host tensors; the surgery walks them as Python lists.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch

from repro_torch.core import ir
from repro_torch.core.ir import TaskGraph


def rebuild(g: TaskGraph, *,
            drop: Sequence[int] = (),
            dep_subst: Mapping[int, tuple[int, ...]] | None = None,
            new_src: Mapping[int, int] | None = None,
            new_dsts: Mapping[int, tuple[int, ...]] | None = None,
            new_deps: Mapping[int, tuple[int, ...]] | None = None
            ) -> TaskGraph:
    """Apply one batch of deletions/rewrites and return a fresh graph.

    ``drop``       positions to remove.
    ``dep_subst``  dropped position -> replacement positions: every kept
                   task that depended on the dropped position depends on
                   the replacements instead (resolved transitively through
                   other dropped positions).  A dropped position without an
                   entry simply disappears from dependency lists.
    ``new_src``    kept move position -> replacement source PE.
    ``new_dsts``   kept move position -> replacement destination tuple.
    ``new_deps``   kept position -> replacement dependency list (old-space;
                   entries may reference dropped positions, which are then
                   substituted like ordinary deps).
    """
    dropped = frozenset(int(p) for p in drop)
    subst = {int(k): tuple(int(x) for x in v)
             for k, v in (dep_subst or {}).items()}
    new_src = {int(k): int(v) for k, v in (new_src or {}).items()}
    new_dsts = {int(k): tuple(int(x) for x in v)
                for k, v in (new_dsts or {}).items()}
    new_deps = {int(k): tuple(int(x) for x in v)
                for k, v in (new_deps or {}).items()}

    resolved: dict[int, tuple[int, ...]] = {}

    def resolve(p: int) -> tuple[int, ...]:
        """Kept positions a reference to dropped position ``p`` becomes."""
        hit = resolved.get(p)
        if hit is not None:
            return hit
        out: list[int] = []
        for q in subst.get(p, ()):
            if q in dropped:
                out.extend(resolve(q))
            elif q not in out:
                out.append(q)
        resolved[p] = tuple(out)
        return resolved[p]

    n = g.n
    keep = [i for i in range(n) if i not in dropped]
    pos_of = {old: new for new, old in enumerate(keep)}

    dep_pos_l = g.dep_pos.tolist()
    dep_indptr_l = g.dep_indptr.tolist()
    dst_flat_l = g.dst_flat.tolist()
    dst_indptr_l = g.dst_indptr.tolist()
    dst_is_tuple_l = g.dst_is_tuple.tolist()
    src_l = g.src.tolist()
    tags = g.tags if g.tags is not None else ("",) * n

    out_dep_pos: list[int] = []
    out_dep_indptr: list[int] = [0]
    out_dst_flat: list[int] = []
    out_dst_indptr: list[int] = [0]
    out_dst_is_tuple: list[bool] = []
    out_src: list[int] = []
    for i in keep:
        deps = new_deps.get(i)
        if deps is None:
            deps = dep_pos_l[dep_indptr_l[i]:dep_indptr_l[i + 1]]
        seen: set[int] = set()
        for d in deps:
            for r in ((d,) if d not in dropped else resolve(d)):
                if r not in seen:
                    seen.add(r)
                    out_dep_pos.append(pos_of[r])
        out_dep_indptr.append(len(out_dep_pos))

        dsts = new_dsts.get(i)
        if dsts is None:
            out_dst_flat.extend(
                dst_flat_l[dst_indptr_l[i]:dst_indptr_l[i + 1]])
            out_dst_is_tuple.append(dst_is_tuple_l[i])
        else:
            out_dst_flat.extend(dsts)
            out_dst_is_tuple.append(len(dsts) > 1)
        out_dst_indptr.append(len(out_dst_flat))
        out_src.append(new_src.get(i, src_l[i]))

    keep_idx = torch.tensor(keep, dtype=torch.int64)
    return ir.freeze(TaskGraph(
        uids=g.uids[keep_idx],
        kinds=g.kinds[keep_idx],
        dep_indptr=torch.tensor(out_dep_indptr, dtype=torch.int64),
        dep_pos=torch.tensor(out_dep_pos, dtype=torch.int64),
        duration=g.duration[keep_idx],
        op_class=g.op_class[keep_idx],
        pe=g.pe[keep_idx],
        src=torch.tensor(out_src, dtype=torch.int64),
        dst_indptr=torch.tensor(out_dst_indptr, dtype=torch.int64),
        dst_flat=torch.tensor(out_dst_flat, dtype=torch.int64),
        dst_is_tuple=torch.tensor(out_dst_is_tuple, dtype=torch.bool),
        rows=g.rows[keep_idx],
        tags=tuple(tags[i] for i in keep),
    ))


def graphs_equal(a: TaskGraph, b: TaskGraph) -> bool:
    """Structural equality over every array field plus tags."""
    if a.n != b.n:
        return False
    for f in ir.ARRAY_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        # values compared as np.array_equal does: same shape, equal
        # elements after promotion
        if x.shape != y.shape or not bool((x == y).all()):
            return False
    ta = a.tags if a.tags is not None else ("",) * a.n
    tb = b.tags if b.tags is not None else ("",) * b.n
    return ta == tb
