"""Legacy pure-Python single-bank scheduler, preserved for differential use
(port of ``repro/core/reference.py``, verbatim: plain Python, no tensors).

This is the pre-refactor implementation of :func:`repro_torch.core.scheduler
.schedule`, kept for two jobs:

1. **Differential testing** — the golden schedules and the engine tests
   check that the resource-token engine (:mod:`repro_torch.core.engine`)
   reproduces this code bit-for-bit on golden and randomized graphs; on a
   card, ``chip_smoke.py`` holds the engine's schedules against it.
2. **Honest baselines** — the per-config loop a batched sweep is timed
   against.

Do not extend this module: new interconnect semantics belong in a
:class:`repro_torch.core.engine.ResourceModel`.
"""

from __future__ import annotations

import heapq
from typing import Iterable, Sequence

from repro_torch.core import copy_models
from repro_torch.core.pluto import Interconnect
from repro_torch.core.scheduler import ScheduleResult, Task, _dsts  # noqa: F401


class Bank:
    """Resource state for one DRAM bank."""

    def __init__(self, n_pes: int = 16):
        self.n_pes = n_pes
        self.pe_free = [0.0] * n_pes      # earliest free time per subarray PE
        self.bus_free = 0.0               # Shared-PIM BK-bus
        self.tx_free = [0.0] * n_pes      # shared-row transmit token
        self.rx_free = [0.0] * n_pes      # shared-row receive token


def _move_latency(mode: Interconnect, src: int, dst: Sequence[int],
                  rows: int) -> float:
    if mode is Interconnect.LISA:
        # LISA has no broadcast: one serial copy per destination, each with
        # distance-dependent RBM chains; `rows` row hand-offs each.
        total = 0.0
        for d in dst:
            dist = max(1, abs(d - src))
            total += rows * copy_models.lisa_copy(distance=dist).latency_ns
        return total
    # Shared-PIM: distance independent; broadcast amortizes tRAS across <=4
    # destinations in one bus transaction.
    if len(dst) == 1:
        return rows * copy_models.sharedpim_copy().latency_ns
    lat = 0.0
    remaining = list(dst)
    while remaining:
        grp = remaining[:4]
        remaining = remaining[4:]
        lat += rows * copy_models.sharedpim_broadcast(dests=tuple(grp)).latency_ns
    return lat


def _critical_path(tasks: dict[int, Task], succ: dict[int, list[int]],
                   mode: Interconnect) -> dict[int, float]:
    """Longest path to a sink, used as list-scheduling priority."""
    order = _topo_order(tasks, succ)
    cp: dict[int, float] = {}
    for uid in reversed(order):
        t = tasks[uid]
        dur = t.duration if t.kind == "op" else _move_latency(
            mode, t.src, _dsts(t), t.rows)
        cp[uid] = dur + max((cp[s] for s in succ.get(uid, ())), default=0.0)
    return cp


def _topo_order(tasks: dict[int, Task], succ: dict[int, list[int]]) -> list[int]:
    indeg = {uid: len(t.deps) for uid, t in tasks.items()}
    stack = [uid for uid, d in indeg.items() if d == 0]
    order: list[int] = []
    while stack:
        uid = stack.pop()
        order.append(uid)
        for s in succ.get(uid, ()):
            indeg[s] -= 1
            if indeg[s] == 0:
                stack.append(s)
    if len(order) != len(tasks):
        raise ValueError("task graph has a cycle")
    return order


def schedule(tasks_in: Iterable[Task], mode: Interconnect,
             n_pes: int = 16) -> ScheduleResult:
    """List-schedule a task graph on one bank under the given interconnect."""
    tasks = {t.uid: t for t in tasks_in}
    succ: dict[int, list[int]] = {}
    for t in tasks.values():
        for d in t.deps:
            succ.setdefault(d, []).append(t.uid)
    cp = _critical_path(tasks, succ, mode)

    bank = Bank(n_pes)
    finish: dict[int, float] = {}
    indeg = {uid: len(t.deps) for uid, t in tasks.items()}
    # ready heap: (-critical_path, ready_time, uid)
    ready: list[tuple[float, float, int]] = []
    for uid, d in indeg.items():
        if d == 0:
            heapq.heappush(ready, (-cp[uid], 0.0, uid))

    op_busy = move_busy = stall = 0.0
    n_ops = n_moves = n_rows = 0

    while ready:
        _, ready_t, uid = heapq.heappop(ready)
        t = tasks[uid]
        dep_t = max((finish[d] for d in t.deps), default=0.0)
        if t.kind == "op":
            pe = t.pe % bank.n_pes
            start = max(dep_t, bank.pe_free[pe])
            end = start + t.duration
            bank.pe_free[pe] = end
            op_busy += t.duration
            n_ops += 1
        elif t.kind == "move":
            dsts = _dsts(t)
            src = t.src % bank.n_pes
            dsts = tuple(d % bank.n_pes for d in dsts)
            dur = _move_latency(mode, src, dsts, t.rows)
            if mode is Interconnect.LISA:
                # RBM stalls every subarray in the span for the whole move.
                lo = min((src, *dsts))
                hi = max((src, *dsts))
                start = max(dep_t, *(bank.pe_free[p] for p in range(lo, hi + 1)))
                end = start + dur
                # every PE in the span stalls for the whole move: start is
                # already the span max, so each PE's hold equals the span
                stall += (hi - lo + 1) * (end - start)
                for p in range(lo, hi + 1):
                    bank.pe_free[p] = end
            else:
                # Shared-PIM: bus + shared-row tokens only; PEs keep running.
                start = max(dep_t, bank.bus_free, bank.tx_free[src],
                            *(bank.rx_free[d] for d in dsts))
                end = start + dur
                bank.bus_free = end
                bank.tx_free[src] = end
                for d in dsts:
                    bank.rx_free[d] = end
            move_busy += dur
            n_moves += 1
            n_rows += t.rows * len(dsts)
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
    return ScheduleResult(mode, makespan, op_busy, move_busy, stall,
                          n_ops, n_moves, n_rows, finish)


# --- legacy task-object app builders --------------------------------------------
# The pre-refactor ``core.taskgraph`` built Task lists directly (one Task
# object appended per node, durations baked per mode at build time).
# Preserved verbatim so the sweep baseline's graph construction costs what
# the original per-config loop's did; constants are imported from the live
# module (they are unchanged data).

from repro_torch.core import pluto  # noqa: E402
from repro_torch.core.taskgraph import (  # noqa: E402
    BFS_FETCH_ROWS, GROUP_PES, SLICES_32, SLICES_64, SLICES_NTT_XCHG,
    default_out_slice)
import math  # noqa: E402

def _op32(op: str, mode: Interconnect) -> float:
    # the 32-bit composite op is itself faster under Shared-PIM (Fig 7)
    return pluto.op32_latency_ns(op, mode)


class _Builder:
    def __init__(self, n_pes: int) -> None:
        self.tasks: list[Task] = []
        self.n_pes = n_pes

    def op(self, pe: int, dur: float, deps=(), tag="") -> int:
        uid = len(self.tasks)
        self.tasks.append(Task(uid, "op", tuple(deps), pe=pe % self.n_pes,
                               duration=dur, tag=tag))
        return uid

    def move(self, src: int, dst, deps=(), rows=None, tag="") -> int | None:
        """Emit a move; returns None (no-op) if src == dst."""
        rows = SLICES_32 if rows is None else rows
        src %= self.n_pes
        dst = tuple(d % self.n_pes for d in dst) if isinstance(dst, tuple) \
            else dst % self.n_pes
        if dst == src:
            return None
        uid = len(self.tasks)
        self.tasks.append(Task(uid, "move", tuple(deps), src=src, dst=dst,
                               rows=rows, tag=tag))
        return uid


def _dep(*uids) -> tuple[int, ...]:
    return tuple(u for u in uids if u is not None)


def matmul(n: int = 200, n_pes: int = 16,
           mode: Interconnect = Interconnect.LISA,
           out_rows: int | None = None) -> list[Task]:
    """Row-vectorized n x n x n matrix multiply on one bank (Fig 4(b) map).

    ``out_rows`` limits how many output rows are simulated (the schedule is
    identical per row, so the relative makespan is insensitive to it).
    """
    b = _Builder(n_pes)
    t_mul, t_add = _op32("mul", mode), _op32("add", mode)
    n_groups = max(1, n_pes // GROUP_PES)
    rows = min(n, out_rows if out_rows is not None
               else default_out_slice(n_pes))
    for r in range(rows):
        g = r % n_groups
        prod_a, agg, prod_b = 3 * g, 3 * g + 1, 3 * g + 2
        acc = None
        for k in range(n):
            src = prod_a if k % 2 == 0 else prod_b
            u = b.op(src, t_mul, tag=f"mm.mul r{r}k{k}")
            mv = b.move(src, agg, deps=_dep(u), rows=SLICES_64, tag="mm.mv")
            acc = b.op(agg, t_add, deps=_dep(mv, acc), tag="mm.acc")
    return b.tasks


def pmm(n: int = 300, n_pes: int = 16,
        mode: Interconnect = Interconnect.LISA,
        out_coeffs: int | None = None) -> list[Task]:
    """Naive degree-n polynomial multiplication (paper: n=300, no NTT).

    Simulates the *longest* output coefficients (k around n-1, with ~n
    products each) — these dominate the makespan at full parallelism.
    """
    b = _Builder(n_pes)
    t_mul, t_add = _op32("mul", mode), _op32("add", mode)
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
            u = b.op(pe, t_mul, tag=f"pmm.mul k{k}i{i}")
            mv = b.move(pe, home, deps=_dep(u), rows=SLICES_64, tag="pmm.mv")
            acc = b.op(home, t_add, deps=_dep(mv, acc), tag="pmm.acc")
    return b.tasks


def ntt(n: int = 512, n_pes: int = 16,
        mode: Interconnect = Interconnect.LISA,
        groups: int | None = None) -> list[Task]:
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
    b = _Builder(n_pes)
    t_mul, t_add = _op32("mul", mode), _op32("add", mode)
    groups = n_pes if groups is None else groups
    stages = int(math.log2(n))
    prev: dict[int, tuple[int, ...]] = {g: () for g in range(groups)}
    for s in range(stages):
        cur: dict[int, tuple[int, ...]] = {}
        for g in range(groups):
            partner = g + 1 if g % 2 == 0 else g - 1
            mul = b.op(g, t_mul, deps=prev[g], tag=f"ntt.tw s{s}g{g}")
            add = b.op(g, t_add, deps=_dep(mul), tag="ntt.add")
            sub = b.op(g, t_add, deps=_dep(mul), tag="ntt.sub")
            mv1 = b.move(g, partner, deps=_dep(add), rows=SLICES_NTT_XCHG,
                         tag="ntt.xchg")
            mv2 = b.move(g, partner, deps=_dep(sub), rows=SLICES_NTT_XCHG,
                         tag="ntt.xchg")
            cur[g] = _dep(mv1, mv2)
        prev = cur
    return b.tasks


def bfs(n_nodes: int = 1000, n_pes: int = 16,
        mode: Interconnect = Interconnect.LISA,
        n_stripes: int = 1) -> list[Task]:
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
    if n_pes % n_stripes:
        raise ValueError(f"n_pes ({n_pes}) must be divisible by n_stripes "
                         f"({n_stripes})")
    stripe_w = n_pes // n_stripes
    if stripe_w < 3:
        raise ValueError("each stripe needs >= 3 PEs (storage + 2 visit PEs)")
    b = _Builder(n_pes)
    t_upd = _op32("add", mode)   # compare/update modeled as a 32-bit op pass
    prev_upd: int | None = None
    prev_mv: int | None = None
    for v in range(n_nodes):
        store = (v % n_stripes) * stripe_w   # stripe holding node v's segment
        proc = 1 + (v % 2)                   # double-buffered visit PEs
        mv = b.move(store, proc, deps=_dep(prev_mv), rows=BFS_FETCH_ROWS,
                    tag=f"bfs.fetch v{v}")
        upd = b.op(proc, t_upd, deps=_dep(mv, prev_upd), tag="bfs.update")
        prev_mv, prev_upd = mv, upd
    return b.tasks


def dfs(n_nodes: int = 1000, n_pes: int = 16,
        mode: Interconnect = Interconnect.LISA,
        n_stripes: int = 1) -> list[Task]:
    """Worst-case DFS == worst-case BFS on the same dense graph (Sec IV-D)."""
    return bfs(n_nodes, n_pes, mode, n_stripes=n_stripes)


APPS = {"mm": matmul, "pmm": pmm, "ntt": ntt, "bfs": bfs, "dfs": dfs}


def build(app: str, mode: Interconnect, **kw) -> list[Task]:
    return APPS[app](mode=mode, **kw)
