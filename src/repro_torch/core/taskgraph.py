"""Application task graphs for the Fig-8 benchmarks (PyTorch port of
``repro/core/taskgraph.py``).

Data layout convention (follows the Fig-7 composition): a 32-bit operand set
(one row-vector of elements) is nibble-sliced across ``SLICES_32 = 8``
subarray rows, so handing a 32-bit value set from one PE to another is 8 row
moves — and a 32x32 *product* is a 64-bit value, i.e. ``2 * SLICES_32 = 16``
row moves.  Compute ops are row-vectorized: one "op" task applies a 32-bit
pLUTo add/mul across every element lane of a row.

Placement is locality-aware (what a reasonable PIM compiler would emit):
producers/consumers are mapped to nearby subarrays, so LISA pays short RBM
chains rather than worst-case spans; Shared-PIM is distance-independent.

Graph shapes (mapping mirrors the paper's Fig 4 examples):

* ``matmul(n)``   — Fig 4(b) literally: pipeline groups of three adjacent
  subarrays — two producers computing products A_i x B_i / C_i x D_i around
  one aggregator.  Every 64-bit product is "immediately moved" to the
  aggregator, which serially accumulates while producers continue.
* ``pmm(n)``      — naive polynomial multiply, degree n: same producer/
  aggregator structure per output coefficient, but products arrive from the
  subarrays holding the scattered a_i operands (distance 1-2) — a higher
  move:compute ratio than MM, hence the larger win the paper reports.
* ``ntt(n)``      — log2(n) constant-geometry butterfly stages; each group:
  twiddle mul + butterfly add and sub, then both 32-bit outputs exchange with
  the adjacent stage partner.  Tight inter-stage dependencies keep moves on
  the critical path -> smaller win.
* ``bfs(n)/dfs(n)`` — worst-case dense-graph traversal: a serial visit chain;
  the next node's adjacency segment (4 rows) + distance-vector slices
  (2 rows) are prefetched from the storage subarray while the current update
  runs (double-buffered visit PEs).  BFS == DFS in the worst case (Sec IV-D).

Graph **structure** is interconnect independent — only op durations change
with the mode — so each builder constructs a structural
:class:`~repro_torch.core.ir.TaskGraph` once per problem shape (memoized with
``functools.lru_cache``) with symbolic "add"/"mul" op classes, and
:func:`build_ir` materializes durations for a concrete mode in one
vectorized lookup.  The legacy ``list[Task]`` entry points are preserved as
converting wrappers.

The builders emit **logical** IR: virtual PEs, symbolic op classes, every
hand-off spelled out.  Physical decisions belong to the passes pipeline
(``repro/passes`` in the reference: placement is its place stage, and
redundant-move cleanup its optimize stage), which the port does not have
yet, so ``build_ir(app, mode, opt=...)`` with passes raises.  With no
passes — the default — the graphs are bit for bit the reference's (the
golden schedules pin this).
"""

from __future__ import annotations

import functools
import inspect
import math

import importlib.util

from repro_torch.core import ir
from repro_torch.core.ir import TaskGraph
from repro_torch.core.pluto import Interconnect

#: row hand-offs to move one 32-bit row-vector between subarrays
SLICES_32 = 8
#: a 32x32 multiply produces 64-bit partials -> twice the slices
SLICES_64 = 2 * SLICES_32
#: constant-geometry NTT stages exchange only the lanes that cross groups —
#: half of each 32-bit row-vector per stage
SLICES_NTT_XCHG = SLICES_32 // 2
#: BFS visit fetch: 4 rows adjacency segment + 2 rows distance vector + 1 row
#: frontier bitmap
BFS_FETCH_ROWS = 7
#: subarrays per Fig-4(b) pipeline group: two producers around one aggregator
GROUP_PES = 3


def default_out_slice(n_pes: int) -> int:
    """Output rows/coeffs that saturate ``n_pes`` subarrays (2 per group).

    This is the slice mm/pmm simulate by default; device-scale strong-scaling
    sweeps pin it to the largest swept device so total work stays fixed.
    """
    return 2 * max(1, n_pes // GROUP_PES)


class _Builder:
    """Structural builder: ops carry symbolic classes, not latencies."""

    def __init__(self, n_pes: int) -> None:
        self.b = ir.GraphBuilder()
        self.n_pes = n_pes

    def op(self, pe: int, cls: str, deps=(), tag="") -> int:
        return self.b.op(pe % self.n_pes, deps, op_class=cls, tag=tag)

    def move(self, src: int, dst, deps=(), rows=None, tag="") -> int | None:
        """Emit a move; returns None (no-op) if src == dst."""
        rows = SLICES_32 if rows is None else rows
        src %= self.n_pes
        dst = tuple(d % self.n_pes for d in dst) if isinstance(dst, tuple) \
            else dst % self.n_pes
        if dst == src:
            return None
        return self.b.move(src, dst, deps, rows=rows, tag=tag)

    def build(self) -> TaskGraph:
        return self.b.build()


def _dep(*uids) -> tuple[int, ...]:
    return tuple(u for u in uids if u is not None)


@functools.lru_cache(maxsize=None)
def _matmul_struct(n: int, n_pes: int, out_rows: int | None) -> TaskGraph:
    b = _Builder(n_pes)
    n_groups = max(1, n_pes // GROUP_PES)
    rows = min(n, out_rows if out_rows is not None
               else default_out_slice(n_pes))
    for r in range(rows):
        g = r % n_groups
        prod_a, agg, prod_b = 3 * g, 3 * g + 1, 3 * g + 2
        acc = None
        for k in range(n):
            src = prod_a if k % 2 == 0 else prod_b
            u = b.op(src, "mul", tag=f"mm.mul r{r}k{k}")
            mv = b.move(src, agg, deps=_dep(u), rows=SLICES_64, tag="mm.mv")
            acc = b.op(agg, "add", deps=_dep(mv, acc), tag="mm.acc")
    return b.build()


@functools.lru_cache(maxsize=None)
def _pmm_struct(n: int, n_pes: int, out_coeffs: int | None) -> TaskGraph:
    b = _Builder(n_pes)
    n_groups = max(1, n_pes // GROUP_PES)
    n_out = min(2 * n - 1, out_coeffs if out_coeffs is not None
                else default_out_slice(n_pes))
    ks = range(n - 1 - n_out // 2, n - 1 + (n_out + 1) // 2)
    for j, k in enumerate(ks):
        home = 3 * (j % n_groups)
        lo, hi = max(0, k - (n - 1)), min(k, n - 1)
        acc = None
        for i in range(lo, hi + 1):
            # products computed where the scattered a_i operands live:
            # distance 1 or 2 from the coefficient's home subarray
            pe = home + (1 if i % 3 < 2 else 2)
            u = b.op(pe, "mul", tag=f"pmm.mul k{k}i{i}")
            mv = b.move(pe, home, deps=_dep(u), rows=SLICES_64, tag="pmm.mv")
            acc = b.op(home, "add", deps=_dep(mv, acc), tag="pmm.acc")
    return b.build()


@functools.lru_cache(maxsize=None)
def _ntt_struct(n: int, n_pes: int, groups: int | None) -> TaskGraph:
    b = _Builder(n_pes)
    groups = n_pes if groups is None else groups
    stages = int(math.log2(n))
    prev: dict[int, tuple[int, ...]] = {g: () for g in range(groups)}
    for s in range(stages):
        cur: dict[int, tuple[int, ...]] = {}
        for g in range(groups):
            partner = g + 1 if g % 2 == 0 else g - 1
            mul = b.op(g, "mul", deps=prev[g], tag=f"ntt.tw s{s}g{g}")
            add = b.op(g, "add", deps=_dep(mul), tag="ntt.add")
            sub = b.op(g, "add", deps=_dep(mul), tag="ntt.sub")
            mv1 = b.move(g, partner, deps=_dep(add), rows=SLICES_NTT_XCHG,
                         tag="ntt.xchg")
            mv2 = b.move(g, partner, deps=_dep(sub), rows=SLICES_NTT_XCHG,
                         tag="ntt.xchg")
            cur[g] = _dep(mv1, mv2)
        prev = cur
    return b.build()


@functools.lru_cache(maxsize=None)
def _bfs_struct(n_nodes: int, n_pes: int, n_stripes: int) -> TaskGraph:
    if n_pes % n_stripes:
        raise ValueError(f"n_pes ({n_pes}) must be divisible by n_stripes "
                         f"({n_stripes})")
    stripe_w = n_pes // n_stripes
    if stripe_w < 3:
        raise ValueError("each stripe needs >= 3 PEs (storage + 2 visit PEs)")
    b = _Builder(n_pes)
    prev_upd: int | None = None
    prev_mv: int | None = None
    for v in range(n_nodes):
        store = (v % n_stripes) * stripe_w   # stripe holding node v's segment
        proc = 1 + (v % 2)                   # double-buffered visit PEs
        mv = b.move(store, proc, deps=_dep(prev_mv), rows=BFS_FETCH_ROWS,
                    tag=f"bfs.fetch v{v}")
        # compare/update modeled as a 32-bit op pass
        upd = b.op(proc, "add", deps=_dep(mv, prev_upd), tag="bfs.update")
        prev_mv, prev_upd = mv, upd
    return b.build()


def matmul(n: int = 200, n_pes: int = 16,
           mode: Interconnect = Interconnect.LISA,
           out_rows: int | None = None) -> list:
    """Row-vectorized n x n x n matrix multiply on one bank (Fig 4(b) map).

    ``out_rows`` limits how many output rows are simulated (the schedule is
    identical per row, so the relative makespan is insensitive to it).
    """
    return build("mm", mode, n=n, n_pes=n_pes, out_rows=out_rows)


def pmm(n: int = 300, n_pes: int = 16,
        mode: Interconnect = Interconnect.LISA,
        out_coeffs: int | None = None) -> list:
    """Naive degree-n polynomial multiplication (paper: n=300, no NTT).

    Simulates the *longest* output coefficients (k around n-1, with ~n
    products each) — these dominate the makespan at full parallelism.
    """
    return build("pmm", mode, n=n, n_pes=n_pes, out_coeffs=out_coeffs)


def ntt(n: int = 512, n_pes: int = 16,
        mode: Interconnect = Interconnect.LISA,
        groups: int | None = None) -> list:
    """Iterative radix-2 constant-geometry NTT over n points.

    Points are row-vectorized across lanes; by default we model ``n_pes``
    row-groups (the bank-saturating configuration), so the simulated work
    grows with the device.  Strong-scaling sweeps pass an explicit
    ``groups`` (pinned to the largest device) to hold total work fixed —
    extra groups beyond ``n_pes`` wrap onto the PEs and serialize.  Each
    stage: twiddle mul + butterfly add/sub, then both 32-bit outputs
    exchange with the adjacent partner (constant-geometry keeps partners at
    stride 1 every stage).
    """
    return build("ntt", mode, n=n, n_pes=n_pes, groups=groups)


def bfs(n_nodes: int = 1000, n_pes: int = 16,
        mode: Interconnect = Interconnect.LISA,
        n_stripes: int = 1) -> list:
    """Worst-case BFS on a dense graph: every node links to every other.

    Storage subarray 0 holds the adjacency matrix; visits alternate between
    two processing subarrays so the next fetch can be prefetched (the visit
    order of the dense worst case is known) while the current update runs.
    The frontier/state dependency still serializes the updates themselves.

    ``n_stripes > 1`` makes the builder bank-aware for device-scale runs:
    the adjacency matrix is too large for one bank, so node ``v``'s segment
    is striped across ``n_stripes`` equal PE blocks (one per bank when the
    device partitioner passes ``n_stripes=n_banks``) while the traversal
    engine — frontier, distance vector, visit PEs — stays in block 0.  The
    serial visit chain is unchanged, but ``(n_stripes - 1)/n_stripes`` of
    the fetches become inter-block prefetch traffic.
    """
    return build("bfs", mode, n_nodes=n_nodes, n_pes=n_pes,
                 n_stripes=n_stripes)


def dfs(n_nodes: int = 1000, n_pes: int = 16,
        mode: Interconnect = Interconnect.LISA,
        n_stripes: int = 1) -> list:
    """Worst-case DFS == worst-case BFS on the same dense graph (Sec IV-D)."""
    return build("dfs", mode, n_nodes=n_nodes, n_pes=n_pes,
                 n_stripes=n_stripes)


APPS = {"mm": matmul, "pmm": pmm, "ntt": ntt, "bfs": bfs, "dfs": dfs}

_STRUCT_FNS = {"mm": _matmul_struct, "pmm": _pmm_struct, "ntt": _ntt_struct,
               "bfs": _bfs_struct, "dfs": _bfs_struct}

#: structural builders and their (keyword, default) cache signatures —
#: derived from the public wrappers' signatures (minus ``mode``), so the
#: problem-size defaults have exactly one source of truth
_STRUCTS = {
    app: (_STRUCT_FNS[app],
          tuple((name, p.default)
                for name, p in inspect.signature(fn).parameters.items()
                if name != "mode"))
    for app, fn in APPS.items()
}


def register_app(app: str, struct_fn, params: tuple) -> None:
    """Register an externally defined structural app builder.

    ``struct_fn(**kw)`` must return a structural :class:`TaskGraph` and
    expose ``cache_clear`` (the sweep runner's cold-start hook clears every
    registered builder); ``params`` is its ``((keyword, default), …)``
    signature, recorded exactly like the builtin apps'.  The model frontend
    (``repro_torch.frontend``, once ported) registers every config-registry
    arch this way.
    """
    if app in APPS:
        raise ValueError(f"cannot re-register builtin app {app!r}")
    if app in _STRUCTS:
        # a silent overwrite would let graphs memoized under the old
        # builder coexist with the new one's in the placement caches
        raise ValueError(f"app {app!r} is already registered")
    if not callable(getattr(struct_fn, "cache_clear", None)):
        raise ValueError(f"app {app!r} builder must expose cache_clear")
    _STRUCTS[app] = (struct_fn, tuple(params))


#: the module that registers the model archs as apps, once it is ported
_FRONTEND = "repro_torch.frontend"


def _load_registered_apps() -> None:
    """Import the entry-point modules that register extra apps.

    Until the port has its model frontend, the builtin apps are all there
    is and this imports nothing.
    """
    if importlib.util.find_spec(_FRONTEND) is not None:
        importlib.import_module(_FRONTEND)


def known_apps(load_registered: bool = True) -> tuple[str, ...]:
    """Every dispatchable app name (builtins + registered model archs)."""
    if load_registered:
        _load_registered_apps()
    return tuple(_STRUCTS)


def structural(app: str, **kw) -> TaskGraph:
    """The memoized mode-independent graph for one problem shape."""
    if app not in _STRUCTS:
        _load_registered_apps()
        if app not in _STRUCTS:
            raise ValueError(
                f"unknown app {app!r}; known: {sorted(_STRUCTS)}")
    fn, sig = _STRUCTS[app]
    kw = dict(kw)
    # pass by keyword: a parameter-order mismatch between a wrapper and its
    # *_struct builder becomes a TypeError instead of a silently swapped
    # argument (all of them are int-or-None)
    full = {name: kw.pop(name, default) for name, default in sig}
    if kw:
        raise TypeError(f"unknown kwargs for {app}: {sorted(kw)}")
    return fn(**full)


def build_ir(app: str, mode: Interconnect, *, opt: tuple = (),
             **kw) -> TaskGraph:
    """Materialized IR graph for (app, mode): the schedulers' fast path.

    ``opt`` names optimization passes to run on the structural graph before
    materializing.  The port has no passes pipeline yet, so a non-empty
    ``opt`` raises; the default — no passes — is the pipeline-off path the
    goldens pin.
    """
    g = structural(app, **kw)
    if opt:
        raise NotImplementedError(
            f"build_ir(opt={tuple(opt)!r}): the passes pipeline is not "
            "ported yet (ROADMAP Queue 1, the passes/ item); build with "
            "opt=()")
    return ir.materialize(g, mode)


def build(app: str, mode: Interconnect, **kw) -> list:
    """The same graph as ``build_ir`` as ``Task`` objects."""
    return ir.to_tasks(build_ir(app, mode, **kw))
