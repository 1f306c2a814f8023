"""Structure-of-arrays TaskGraph IR for the PIM simulator (PyTorch port of
``repro/core/ir.py``).

Every scheduler layer consumes one intermediate representation: a
:class:`TaskGraph` that stores the dataflow graph as flat tensors
(structure of arrays) instead of per-task Python objects.  A graph is host
data: its tensors live on the CPU, are built by Python builders and are
memoized; an engine session copies what its loop needs to its own device.

Layout (``n`` tasks, CSR adjacency):

============== ========== =====================================================
field          dtype      meaning
============== ========== =====================================================
uids           int64[n]   caller-facing task ids (unique, arbitrary ints)
kinds          int8[n]    ``OP`` (compute) or ``MOVE`` (row transfer)
dep_indptr     int64[n+1] CSR row pointer into ``dep_pos``
dep_pos        int64[nnz] dependency *positions* (row indices, not uids)
duration       f64[n]     op latency in ns (0 for moves and unmaterialized ops)
op_class       int16[n]   index into :data:`OP_CLASSES`, or ``-1`` = explicit
pe             int64[n]   op placement (``NONE_SENTINEL`` when absent)
src            int64[n]   move source PE (``NONE_SENTINEL`` when absent)
dst_indptr     int64[n+1] CSR row pointer into ``dst_flat``
dst_flat       int64[m]   move destinations (broadcast = several per move)
dst_is_tuple   bool[n]    original ``Task.dst`` was a tuple (API round-trip)
rows           int64[n]   8KB row hand-offs per move
tags           tuple[str] per-task debug tags (optional)
============== ========== =====================================================

``op_class`` is what makes a graph *mode independent*: app builders record
"this op is a 32-bit add/mul" instead of baking in the latency, and
:func:`materialize` fills ``duration`` for a concrete interconnect.  One
cached structural graph therefore serves every (interconnect, policy,
geometry) configuration of a sweep.

:func:`validate` rejects malformed graphs up front — duplicate uids,
out-of-range kinds, dangling dependencies, and cycles all raise
``ValueError`` naming the offending uids.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterable, Sequence

import torch

from repro_torch.core import pluto
from repro_torch.core.pluto import Interconnect

#: task kinds
OP, MOVE = 0, 1
KIND_NAMES = ("op", "move")

#: symbolic op classes a builder may emit instead of explicit durations;
#: materialized per interconnect via :func:`pluto.op32_latency_ns`
OP_CLASSES = ("add", "mul")
_OP_CLASS_INDEX = {name: i for i, name in enumerate(OP_CLASSES)}

#: array encoding of ``None`` for pe/src fields
NONE_SENTINEL = torch.iinfo(torch.int64).min

#: cap on how many uids an error message spells out
_MAX_ERR_UIDS = 20

_I64 = torch.int64

#: the array fields of a graph, in declaration order
ARRAY_FIELDS = ("uids", "kinds", "dep_indptr", "dep_pos", "duration",
                "op_class", "pe", "src", "dst_indptr", "dst_flat",
                "dst_is_tuple", "rows")

#: the fields a graph's fingerprint digests (the reference's trace key)
_FINGERPRINT_FIELDS = ("uids", "kinds", "dep_indptr", "dep_pos", "duration",
                       "op_class", "pe", "src", "dst_indptr", "dst_flat",
                       "rows")


@dataclasses.dataclass
class TaskGraph:
    """Structure-of-arrays dataflow graph (see module docstring)."""

    uids: torch.Tensor
    kinds: torch.Tensor
    dep_indptr: torch.Tensor
    dep_pos: torch.Tensor
    duration: torch.Tensor
    op_class: torch.Tensor
    pe: torch.Tensor
    src: torch.Tensor
    dst_indptr: torch.Tensor
    dst_flat: torch.Tensor
    dst_is_tuple: torch.Tensor
    rows: torch.Tensor
    tags: tuple[str, ...] | None = None
    #: memoized derived structure (successor CSR, levels, validation flag,
    #: engine loop statics).  A *shared mutable dict*: ``dataclasses.replace``
    #: copies the reference, so every materialized/placed copy of one
    #: structural graph — same deps, different durations or placements —
    #: pays for its derived structure exactly once across a whole sweep.
    #: Entries that hold tensors on an engine's device carry the device in
    #: their key.
    _derived: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def n(self) -> int:
        return len(self.uids)

    # --- per-task views ---------------------------------------------------------

    def deps_of(self, i: int) -> torch.Tensor:
        return self.dep_pos[self.dep_indptr[i]:self.dep_indptr[i + 1]]

    def dsts_of(self, i: int) -> torch.Tensor:
        return self.dst_flat[self.dst_indptr[i]:self.dst_indptr[i + 1]]

    # --- derived structure ------------------------------------------------------

    def successors(self) -> tuple[torch.Tensor, torch.Tensor]:
        """CSR successor adjacency ``(succ_indptr, succ_flat)``.

        ``succ_flat[succ_indptr[i]:succ_indptr[i+1]]`` lists the positions of
        tasks that depend on task ``i`` (duplicates preserved, mirroring the
        dependency multiset).
        """
        cached = self._derived.get("succ")
        if cached is not None:
            return cached
        n = self.n
        counts = torch.bincount(self.dep_pos, minlength=n) \
            if len(self.dep_pos) else torch.zeros(n, dtype=_I64)
        indptr = torch.zeros(n + 1, dtype=_I64)
        indptr[1:] = torch.cumsum(counts, 0)
        if len(self.dep_pos):
            owners = torch.repeat_interleave(torch.arange(n, dtype=_I64),
                                             torch.diff(self.dep_indptr))
            order = torch.argsort(self.dep_pos, stable=True)
            flat = owners[order]
        else:
            flat = torch.zeros(0, dtype=_I64)
        self._derived["succ"] = (_frozen(indptr), _frozen(flat))
        return self._derived["succ"]

    def levels(self) -> torch.Tensor:
        """Topological depth per task (0 = source), via vectorized Kahn.

        Tasks left unassigned by the sweep sit on a cycle; they keep depth
        ``-1`` and :func:`validate` turns them into an error.
        """
        cached = self._derived.get("levels")
        if cached is not None:
            return cached
        n = self.n
        depth = torch.full((n,), -1, dtype=_I64)
        if n == 0:
            self._derived["levels"] = _frozen(depth)
            return self._derived["levels"]
        indeg = torch.diff(self.dep_indptr)
        succ_indptr, succ_flat = self.successors()
        frontier = torch.nonzero(indeg == 0).flatten()
        level = 0
        while len(frontier):
            depth[frontier] = level
            # gather all successor slots of the frontier in one shot
            starts = succ_indptr[frontier]
            counts = succ_indptr[frontier + 1] - starts
            total = int(counts.sum())
            if total == 0:
                break
            seg_starts = torch.cumsum(counts, 0) - counts
            within = torch.arange(total, dtype=_I64) \
                - torch.repeat_interleave(seg_starts, counts)
            hits = succ_flat[torch.repeat_interleave(starts, counts) + within]
            dec = torch.bincount(hits, minlength=n)
            indeg = indeg - dec
            frontier = torch.nonzero((indeg == 0) & (dec > 0)).flatten()
            level += 1
        self._derived["levels"] = _frozen(depth)
        return self._derived["levels"]

    def validate(self) -> None:
        """Raise ``ValueError`` naming offending uids for malformed graphs.

        A clean pass is memoized (and survives ``dataclasses.replace``
        copies, whose structure is unchanged), so repeated scheduling of one
        graph validates once.
        """
        n = self.n
        if n == 0 or self._derived.get("validated"):
            return
        uniq, counts = torch.unique(self.uids, return_counts=True)
        if len(uniq) != n:
            raise ValueError(
                "duplicate task uids: "
                f"{_fmt_uids(uniq[counts > 1])}")
        bad_kind = torch.nonzero((self.kinds != OP)
                                 & (self.kinds != MOVE)).flatten()
        if len(bad_kind):
            raise ValueError(
                f"unknown task kind for uids {_fmt_uids(self.uids[bad_kind])}")
        no_pe = (self.kinds == OP) & (self.pe == NONE_SENTINEL)
        if bool(no_pe.any()):
            raise ValueError(
                f"ops without a pe: uids {_fmt_uids(self.uids[no_pe])}")
        moves = self.kinds == MOVE
        no_src = moves & (self.src == NONE_SENTINEL)
        if bool(no_src.any()):
            raise ValueError(
                f"moves without a src: uids {_fmt_uids(self.uids[no_src])}")
        no_dst = moves & (torch.diff(self.dst_indptr) == 0)
        if bool(no_dst.any()):
            raise ValueError(
                f"moves without destinations: uids "
                f"{_fmt_uids(self.uids[no_dst])}")
        if len(self.dep_pos):
            oob = (self.dep_pos < 0) | (self.dep_pos >= n)
            if bool(oob.any()):
                owners = torch.repeat_interleave(torch.arange(n, dtype=_I64),
                                                 torch.diff(self.dep_indptr))
                raise ValueError(
                    "dangling deps: tasks "
                    f"{_fmt_uids(self.uids[torch.unique(owners[oob])])} "
                    "depend on uids that are not in the graph")
        depth = self.levels()
        cyc = torch.nonzero(depth < 0).flatten()
        if len(cyc):
            raise ValueError(
                f"task graph has a cycle through uids "
                f"{_fmt_uids(self.uids[cyc])}")
        self._derived["validated"] = True


def _frozen(t: torch.Tensor) -> torch.Tensor:
    """``t`` as an inference tensor: any later in-place write raises."""
    if t.is_inference():
        return t
    with torch.inference_mode():
        return t.clone()


def freeze(g: TaskGraph) -> TaskGraph:
    """Mark every array of ``g`` write-protected and return it.

    Built/cached graphs are shared process-wide (``lru_cache`` in the app
    builders) and across ``dataclasses.replace`` copies.  Torch has no
    read-only tensors, so each array becomes an inference tensor: an
    in-place write outside ``torch.inference_mode`` raises ``RuntimeError``
    at once.  (The write itself is not undone, so the error flags the bug
    where it happens rather than preventing it.)
    """
    for f in ARRAY_FIELDS:
        setattr(g, f, _frozen(getattr(g, f)))
    return g


def graph_fingerprint(g: TaskGraph) -> str:
    """Short stable digest of a graph's arrays (the trace provenance key).

    Two graphs with identical structure, placement, durations, and row
    counts fingerprint identically; any rewrite changes it.  The bytes are
    each array's in its own dtype, so a graph carried over from the
    reference fingerprints as it does there.
    """
    h = hashlib.sha256()
    for f in _FINGERPRINT_FIELDS:
        a = getattr(g, f)
        h.update(f.encode())
        h.update(a.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _fmt_uids(uids: Iterable[int]) -> str:
    if isinstance(uids, torch.Tensor):
        uids = uids.tolist()
    uids = sorted(int(u) for u in uids)
    shown = ", ".join(str(u) for u in uids[:_MAX_ERR_UIDS])
    extra = len(uids) - _MAX_ERR_UIDS
    return f"[{shown}{f', … +{extra} more' if extra > 0 else ''}]"


# --- builders -------------------------------------------------------------------


class GraphBuilder:
    """Append-only builder producing a :class:`TaskGraph` directly.

    Used by the app builders in :mod:`repro_torch.core.taskgraph`; ops may
    carry a symbolic ``op_class`` ("add"/"mul") instead of a concrete
    duration, which keeps the built structure interconnect independent.
    """

    def __init__(self) -> None:
        self._kinds: list[int] = []
        self._dep_indptr: list[int] = [0]
        self._dep_pos: list[int] = []
        self._duration: list[float] = []
        self._op_class: list[int] = []
        self._pe: list[int] = []
        self._src: list[int] = []
        self._dst_indptr: list[int] = [0]
        self._dst_flat: list[int] = []
        self._dst_is_tuple: list[bool] = []
        self._rows: list[int] = []
        self._tags: list[str] = []

    def __len__(self) -> int:
        return len(self._kinds)

    def op(self, pe: int, deps: Sequence[int] = (), *,
           op_class: str | None = None, duration: float = 0.0,
           tag: str = "") -> int:
        uid = len(self._kinds)
        self._kinds.append(OP)
        self._dep_pos.extend(deps)
        self._dep_indptr.append(len(self._dep_pos))
        self._tags.append(tag)
        self._duration.append(duration)
        self._op_class.append(_OP_CLASS_INDEX[op_class]
                              if op_class is not None else -1)
        self._pe.append(pe)
        self._src.append(NONE_SENTINEL)
        self._dst_indptr.append(len(self._dst_flat))
        self._dst_is_tuple.append(False)
        self._rows.append(1)
        return uid

    def move(self, src: int, dst: int | Sequence[int],
             deps: Sequence[int] = (), *, rows: int = 1, tag: str = "") -> int:
        uid = len(self._kinds)
        self._kinds.append(MOVE)
        self._dep_pos.extend(deps)
        self._dep_indptr.append(len(self._dep_pos))
        self._tags.append(tag)
        self._duration.append(0.0)
        self._op_class.append(-1)
        self._pe.append(NONE_SENTINEL)
        self._src.append(src)
        if isinstance(dst, (tuple, list)):
            self._dst_flat.extend(dst)
            self._dst_is_tuple.append(True)
        else:
            self._dst_flat.append(dst)
            self._dst_is_tuple.append(False)
        self._dst_indptr.append(len(self._dst_flat))
        self._rows.append(rows)
        return uid

    def build(self) -> TaskGraph:
        n = len(self._kinds)
        return freeze(TaskGraph(
            uids=torch.arange(n, dtype=_I64),
            kinds=torch.tensor(self._kinds, dtype=torch.int8),
            dep_indptr=torch.tensor(self._dep_indptr, dtype=_I64),
            dep_pos=torch.tensor(self._dep_pos, dtype=_I64),
            duration=torch.tensor(self._duration, dtype=torch.float64),
            op_class=torch.tensor(self._op_class, dtype=torch.int16),
            pe=torch.tensor(self._pe, dtype=_I64),
            src=torch.tensor(self._src, dtype=_I64),
            dst_indptr=torch.tensor(self._dst_indptr, dtype=_I64),
            dst_flat=torch.tensor(self._dst_flat, dtype=_I64),
            dst_is_tuple=torch.tensor(self._dst_is_tuple, dtype=torch.bool),
            rows=torch.tensor(self._rows, dtype=_I64),
            tags=tuple(self._tags),
        ))


def from_tasks(tasks: Iterable) -> TaskGraph:
    """Build a TaskGraph from ``scheduler.Task`` objects.

    Dependencies referencing uids absent from the graph raise ``ValueError``
    naming the offenders.
    """
    tasks = list(tasks)
    n = len(tasks)
    uid_to_pos = {t.uid: i for i, t in enumerate(tasks)}
    if len(uid_to_pos) != n:
        seen: set[int] = set()
        dups: set[int] = set()
        for t in tasks:
            (dups if t.uid in seen else seen).add(t.uid)
        raise ValueError(f"duplicate task uids: {_fmt_uids(dups)}")

    b = GraphBuilder()
    dangling: dict[int, list[int]] = {}
    for i, t in enumerate(tasks):
        deps = []
        for d in t.deps:
            if d not in uid_to_pos:
                dangling.setdefault(t.uid, []).append(d)
            else:
                deps.append(uid_to_pos[d])
        if t.kind == "op":
            b.op(t.pe if t.pe is not None else NONE_SENTINEL, deps,
                 duration=t.duration, tag=t.tag)
        elif t.kind == "move":
            b.move(t.src if t.src is not None else NONE_SENTINEL,
                   tuple(t.dst) if isinstance(t.dst, tuple) else t.dst,
                   deps, rows=t.rows, tag=t.tag)
        else:
            raise ValueError(f"unknown task kind {t.kind!r} (uid {t.uid})")
    if dangling:
        detail = "; ".join(
            f"task {u} -> missing {_fmt_uids(ds)}"
            for u, ds in sorted(dangling.items())[:_MAX_ERR_UIDS])
        raise ValueError(f"dangling deps: {detail}")
    g = b.build()
    g.uids = torch.tensor([t.uid for t in tasks], dtype=_I64)
    return freeze(g)


def to_tasks(g: TaskGraph) -> list:
    """Convert back to ``scheduler.Task`` objects (API round-trip)."""
    from repro_torch.core.scheduler import Task  # scheduler imports ir

    dep_pos = g.dep_pos.tolist()
    dst_flat = g.dst_flat.tolist()
    dep_indptr = g.dep_indptr.tolist()
    dst_indptr = g.dst_indptr.tolist()
    uids = g.uids.tolist()
    pes = g.pe.tolist()
    srcs = g.src.tolist()
    kinds = g.kinds.tolist()
    durs = g.duration.tolist()
    rows = g.rows.tolist()
    is_tuple = g.dst_is_tuple.tolist()
    tags = g.tags if g.tags is not None else ("",) * g.n
    out = []
    for i in range(g.n):
        deps = tuple(uids[p] for p in dep_pos[dep_indptr[i]:dep_indptr[i + 1]])
        if kinds[i] == OP:
            pe = pes[i]
            out.append(Task(uids[i], "op", deps,
                            pe=None if pe == NONE_SENTINEL else pe,
                            duration=durs[i], tag=tags[i]))
        else:
            dst = dst_flat[dst_indptr[i]:dst_indptr[i + 1]]
            src = srcs[i]
            out.append(Task(
                uids[i], "move", deps,
                src=None if src == NONE_SENTINEL else src,
                dst=tuple(dst) if is_tuple[i] else dst[0],
                rows=rows[i], tag=tags[i]))
    return out


def materialize(g: TaskGraph, mode: Interconnect) -> TaskGraph:
    """Fill symbolic op durations for a concrete interconnect.

    Returns a shallow copy sharing every structural array with ``g``; only
    ``duration`` is fresh.  Ops with explicit durations pass through
    unchanged, so graphs mixing both styles materialize correctly.
    """
    sym = g.op_class >= 0
    if not bool(sym.any()):
        return g
    table = torch.tensor(
        [pluto.op32_latency_ns(name, mode) for name in OP_CLASSES],
        dtype=torch.float64)
    duration = g.duration.clone()
    duration[sym] = table[g.op_class[sym].long()]
    return dataclasses.replace(g, duration=duration)
