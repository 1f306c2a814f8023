"""Vectorized hot path for :class:`~repro_torch.core.engine.EngineSession`
(PyTorch port of ``repro/core/engine_vec.py``).

The scalar event loop in :mod:`repro_torch.core.engine` dispatches one task
per Python iteration: pop, probe each claimed token's free time, max,
assign, push successors.  This module keeps the *decisions* bit-for-bit
identical while executing them in bulk, with the session's state on the
session's device:

* **Structure-of-arrays plans** (:class:`PlanSoA`): each
  :class:`~repro_torch.core.engine.Compiled` plan is flattened once into
  token-id tensors with CSR offsets (claim tokens, stall groups) on the
  device, so a whole group of tasks' free-time searches run as one
  segmented maximum over a single gather.
* **Batched frontier dispatch**: :func:`advance` drains a *prefix* of the
  ready frontier whose members are provably independent — mutually
  disjoint token claims, priorities strictly ahead of every member's
  successors, no refresh due, no job completion when the caller asked to
  stop on one — and executes the whole group at once.

**Where the state lives.**  The token free times (``session.free``), the
per-task ready times, in-degrees and finish times, the plan's CSR arrays,
the successor CSR and the frontier columns are tensors on the session's
device; the gathers, scatters and segmented maxima of a batch run there.
The ready frontier stays a sorted Python list of key tuples on the host,
and each dispatched batch comes back in one device-to-host copy, which
feeds the heap pushes and the float accumulators.  Static per-task facts
the host needs to form a batch (claims, successor lists, the formation
bound) are kept as host lists beside the device copies.

**The scalar engine is the differential oracle.**  Every cut condition
above is an *equivalence* condition: a batch is exactly the sequence of
tasks the scalar loop would have popped next, executed on disjoint tokens,
so starts, ends, and every accumulator see the same IEEE operations in the
same order.  Sequential float sums are taken on the host, left to right
after the batch's copy (a device ``cumsum`` is a parallel scan and may
round differently); ``stall += cnt * span`` multiplies on the device and
adds on the host, so it rounds twice, as the scalar loop does.

General multi-segment moves (cross-bank) still execute per task — their
segment interleavings are irreducibly sequential — but *inside* a batch:
token disjointness makes their interleaving with vectorized members exact,
and their accounting contributions are merged back in member order.

One repair against the reference: when ``advance(stop_on_completion=True)``
returned with successor pushes appended but not yet sorted into the
frontier, the reference dropped the re-sort flag, so the next call could
pop out of priority order and diverge from the scalar loop.  The flag is
kept on the session here.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from bisect import insort

import torch

from repro_torch.core.engine import CIRCUIT, Compiled, _dev_key

#: largest number of tasks committed as one vectorized group (memory bound;
#: formation usually cuts far earlier on token conflicts or priorities)
BATCH_CAP = 8192

#: batches at or under this size execute member-by-member through the
#: scalar-exact fast path on the batch's host copy — the vectorized
#: gathers carry a few tens of fixed-cost tensor calls per dispatch, which
#: narrow frontiers never amortize
SCALAR_K = 32

_INF = float("inf")
_F64 = torch.float64
_I64 = torch.int64


# --- structure-of-arrays plans ---------------------------------------------------


@dataclasses.dataclass
class PlanSoA:
    """Flat-array view of a :class:`Compiled` plan (built once per device).

    Single-claim tasks (ops and pre-flattened intra-bank moves — everything
    the vector path executes) and general multi-segment moves (executed per
    task inside a batch; their exec tuple has one element) differ here only
    in the claim CSR (``tok_indptr``/``tok_flat``): it holds each
    single-claim task's tokens and is empty for a general move, whose
    ``claim`` instead carries the union of all segment tokens, used only
    for batch conflict detection.  Stall groups mirror the exec tuples'
    ``stall_counts`` as a CSR of float counts (``stall += cnt * span`` must
    multiply with the same IEEE operands the scalar loop uses).

    The tensors live on one device; ``simple_l``, ``tok_indptr_l`` and
    ``sg_indptr_l`` are host lists of the same facts, which batch
    formation and sizing read without a device round trip.
    """

    dur: torch.Tensor           # f64[n] claim duration (0 for general)
    tok_indptr: torch.Tensor    # int64[n+1]
    tok_flat: torch.Tensor      # int64
    sg_indptr: torch.Tensor     # int64[n+1] stall-group CSR
    sg_cnt: torch.Tensor        # f64 stalled-PE count per group
    claim: list                 # per task: int token, or tuple of tokens
    simple: torch.Tensor        # bool[n]: exactly one claimed token
    tok0: torch.Tensor          # int64[n]: that token (-1 when not simple)
    simple_l: list              # host copy of ``simple``
    tok_indptr_l: list          # host copy of ``tok_indptr``
    sg_indptr_l: list           # host copy of ``sg_indptr``


def get_soa(comp: Compiled, device: torch.device) -> PlanSoA:
    """The (cached) SoA view of a compiled plan on ``device``."""
    cache = comp.soa
    if cache is None:
        cache = comp.soa = {}
    key = _dev_key(device)
    soa = cache.get(key)
    if soa is None:
        host = cache.get("cpu")
        if host is None:
            host = cache["cpu"] = _build_soa(comp)
        soa = host if key == "cpu" else _to_device(host, device)
        cache[key] = soa
    return soa


def _to_device(s: PlanSoA, device: torch.device) -> PlanSoA:
    moved = {f.name: (getattr(s, f.name).to(device)
                      if isinstance(getattr(s, f.name), torch.Tensor)
                      else getattr(s, f.name))
             for f in dataclasses.fields(s)}
    return PlanSoA(**moved)


def _build_soa(comp: Compiled) -> PlanSoA:
    plan = comp.exec_plan
    n = len(plan)
    dur = [0.0] * n
    tok_counts = [0] * n
    sg_counts = [0] * n
    tok_flat: list = []
    sg_flat: list = []
    claim: list = [None] * n
    for i, p in enumerate(plan):
        lp = len(p)
        if lp == 2:
            rid, du = p
            claim[i] = rid
            tok_flat.append(rid)
            tok_counts[i] = 1
            dur[i] = du
        elif lp == 3:
            rids, stall_counts, du = p
            claim[i] = rids
            tok_flat.extend(rids)
            tok_counts[i] = len(rids)
            dur[i] = du
            if stall_counts:
                sg_flat.extend(stall_counts)
                sg_counts[i] = len(stall_counts)
        else:
            toks: dict = {}
            for seg in p[0]:
                if seg[0] == CIRCUIT:
                    for r in seg[1]:
                        toks[r] = None
                else:
                    for leg in (seg[1], seg[2], seg[3]):
                        for r in leg:
                            toks[r] = None
            claim[i] = tuple(toks)
    tok_indptr = torch.zeros(n + 1, dtype=_I64)
    tok_indptr[1:] = torch.cumsum(torch.tensor(tok_counts, dtype=_I64), 0)
    sg_indptr = torch.zeros(n + 1, dtype=_I64)
    sg_indptr[1:] = torch.cumsum(torch.tensor(sg_counts, dtype=_I64), 0)
    tok_flat_t = torch.tensor(tok_flat, dtype=_I64)
    simple_l = [c == 1 for c in tok_counts]
    simple = torch.tensor(simple_l, dtype=torch.bool)
    tok0 = torch.full((n,), -1, dtype=_I64)
    tok0[simple] = tok_flat_t[tok_indptr[:-1][simple]]
    return PlanSoA(torch.tensor(dur, dtype=_F64), tok_indptr, tok_flat_t,
                   sg_indptr, torch.tensor(sg_flat, dtype=_F64), claim,
                   simple, tok0, simple_l, tok_indptr.tolist(),
                   sg_indptr.tolist())


# --- growable session arrays -----------------------------------------------------


class GrowBuf:
    """Amortized-doubling append buffer over a tensor on one device."""

    __slots__ = ("a", "n")

    def __init__(self, dtype, cap: int = 64, *, seed=None,
                 device: torch.device | str = "cpu"):
        self.a = torch.empty(max(cap, 1), dtype=dtype, device=device)
        self.n = 0
        if seed is not None:
            self.a[0] = seed
            self.n = 1

    def _grow(self, need: int) -> None:
        if need > len(self.a):
            b = torch.empty(max(need, 2 * len(self.a)), dtype=self.a.dtype,
                            device=self.a.device)
            b[:self.n] = self.a[:self.n]
            self.a = b

    def extend(self, vals: torch.Tensor) -> None:
        need = self.n + len(vals)
        self._grow(need)
        self.a[self.n:need] = vals.to(self.a.device)
        self.n = need

    def extend_fill(self, m: int, value) -> None:
        need = self.n + m
        self._grow(need)
        self.a[self.n:need] = value
        self.n = need


# --- session-side state ----------------------------------------------------------


def init_state(session) -> None:
    """Install the vectorized per-session state (called from __init__)."""
    dev = session.device
    session.free = torch.zeros(session.model.n_resources(), dtype=_F64,
                               device=dev)
    session._v_ready = GrowBuf(_F64, device=dev)
    session._v_indeg = GrowBuf(_I64, device=dev)
    session._v_finish = GrowBuf(_F64, device=dev)
    session._v_dur = GrowBuf(_F64, device=dev)
    session._v_tok_indptr = GrowBuf(_I64, seed=0, device=dev)
    session._v_tok_flat = GrowBuf(_I64, device=dev)
    session._v_sg_indptr = GrowBuf(_I64, seed=0, device=dev)
    session._v_sg_cnt = GrowBuf(_F64, device=dev)
    session._v_succ_indptr = GrowBuf(_I64, seed=0, device=dev)
    session._v_succ_flat = GrowBuf(_I64, device=dev)
    session._v_simple = GrowBuf(torch.bool, device=dev)
    session._v_tok0 = GrowBuf(_I64, device=dev)
    # min successor -critical-path per task (the formation safety bound)
    session._v_M = GrowBuf(_F64, device=dev)
    # host lists of static per-task facts that batch formation and the
    # small-batch path read one element at a time
    session._v_claim: list = []      # per-task claim tokens (int | tuple)
    session._v_M_l: list = []
    session._v_simple_l: list = []
    session._v_tok_indptr_l: list = [0]
    session._v_sg_indptr_l: list = [0]
    session._v_succ_indptr_l: list = [0]
    session._v_succ_flat_l: list = []
    session._v_rq_toks = [torch.tensor(toks, dtype=_I64, device=dev)
                          for _, _, toks
                          in sorted(session._rq, key=lambda t: t[1])]
    # refresh units are normally contiguous token ranges (one block per
    # bank): slice reduce/fill beats fancy indexing per window
    session._v_rq_bounds = []
    for _, _, toks in sorted(session._rq, key=lambda t: t[1]):
        lo = toks[0] if len(toks) else 0
        contig = len(toks) > 0 and list(toks) == list(
            range(lo, lo + len(toks)))
        session._v_rq_bounds.append((lo, lo + len(toks)) if contig
                                    else None)
    # the frontier list is kept *sorted* (not heap-ordered); admits and
    # batch pushes append unsorted and flag a re-sort
    session._heap_dirty = False


def min_succ_neg_cp(succ_indptr: torch.Tensor, succ_flat: torch.Tensor,
                    neg_cp: torch.Tensor) -> torch.Tensor:
    """Per task, the min ``-critical_path`` over its successors (inf if none).

    The batch-formation safety bound: a frontier candidate whose key is
    strictly ahead of every already-drained member's successor bound
    cannot be overtaken by anything those members push.  Computed on the
    tensors' device.
    """
    n = len(succ_indptr) - 1
    m = torch.full((n,), _INF, dtype=_F64, device=neg_cp.device)
    if len(succ_flat):
        owners = torch.repeat_interleave(
            torch.arange(n, dtype=_I64, device=neg_cp.device),
            torch.diff(succ_indptr), output_size=len(succ_flat))
        m.scatter_reduce_(0, owners, neg_cp[succ_flat], "amin",
                          include_self=True)
    return m


def admit_state(session, g, comp: Compiled, at: float, base: int,
                m_local: torch.Tensor, m_list: list) -> None:
    """Append one admitted graph's arrays to the session buffers."""
    n = g.n
    dev = session.device
    soa = get_soa(comp, dev)
    session._v_ready.extend_fill(n, at)
    session._v_indeg.extend(torch.diff(g.dep_indptr))
    session._v_finish.extend_fill(n, 0.0)
    session._v_dur.extend(soa.dur)
    tok_base = session._v_tok_flat.n
    session._v_tok_indptr.extend(soa.tok_indptr[1:] + tok_base)
    session._v_tok_flat.extend(soa.tok_flat)
    sg_base = session._v_sg_cnt.n
    session._v_sg_indptr.extend(soa.sg_indptr[1:] + sg_base)
    session._v_sg_cnt.extend(soa.sg_cnt)
    succ_indptr, succ_flat = g.successors()
    succ_base = session._v_succ_flat.n
    session._v_succ_indptr.extend(succ_indptr[1:] + succ_base)
    session._v_succ_flat.extend(succ_flat + base if base else succ_flat)
    session._v_simple.extend(soa.simple)
    session._v_tok0.extend(soa.tok0)
    session._v_M.extend(m_local)
    session._v_claim.extend(soa.claim)
    session._v_M_l.extend(m_list)
    session._v_simple_l.extend(soa.simple_l)
    session._v_tok_indptr_l.extend(x + tok_base
                                   for x in soa.tok_indptr_l[1:])
    session._v_sg_indptr_l.extend(x + sg_base for x in soa.sg_indptr_l[1:])
    session._v_succ_indptr_l.extend(
        x + succ_base for x in succ_indptr[1:].tolist())
    session._v_succ_flat_l.extend(
        (succ_flat + base if base else succ_flat).tolist())


# --- host <-> device helpers -----------------------------------------------------


def _fetch(parts, device) -> list:
    """One device-to-host copy of several gathers, as one list of floats.

    ``parts`` is a sequence of ``(tensor, positions)``; each tensor is
    gathered at its positions on the device and the gathers come back
    concatenated as float64 (exact for the int64 counts held here).
    """
    idx = []
    for _, pos in parts:
        idx.extend(pos)
    it = torch.tensor(idx, dtype=_I64).to(device)
    out = []
    o = 0
    for t, pos in parts:
        k = len(pos)
        out.append(t[it[o:o + k]].to(_F64))
        o += k
    return torch.cat(out).tolist() if out else []


def _store(parts, device) -> None:
    """Host values written to device tensors: ``(tensor, positions,
    values)`` triples, sent as one index and one value copy."""
    idx = []
    vals = []
    for _, pos, v in parts:
        idx.extend(pos)
        vals.extend(v)
    if not idx:
        return
    it = torch.tensor(idx, dtype=_I64).to(device)
    vt = torch.tensor(vals, dtype=_F64).to(device)
    o = 0
    for t, pos, _ in parts:
        k = len(pos)
        if k:
            t[it[o:o + k]] = vt[o:o + k].to(t.dtype)
        o += k


def _ready_ahead(ready, heap, rp: list, k: int, device) -> None:
    """Extend ``rp`` (the ready times of ``heap[0:len(rp)]``, read from the
    device) past index ``k``; refresh-bearing formation reads them."""
    lo = len(rp)
    hi = min(len(heap), max(k + 1, 2 * lo, 64))
    if hi > lo:
        rp.extend(_fetch([(ready, [h[3] for h in heap[lo:hi]])], device))


# --- sequential-order float reduction --------------------------------------------


def _seqsum(base: float, contrib) -> float:
    """``base + c0 + c1 + ...`` with strictly left-to-right IEEE adds."""
    for c in contrib:
        base += c
    return base


# --- general (multi-segment) member execution ------------------------------------


def _exec_general(p, dep_t, free, bus_busy, energy, mv_out, st_out,
                  rec_segs, i):
    """Scalar-exact execution of one general move against host token times.

    ``free`` maps each token the move claims to its free time (a host copy
    of the device's, written back by the caller).  Mirrors the scalar
    loop's multi-segment branch; move-busy and stall contributions are
    *collected* (``mv_out``/``st_out``) so the caller can merge them with
    the vectorized members' contributions in member order.  Returns
    ``(end, energy)``.
    """
    end = dep_t
    for _sk, seg in enumerate(p[0]):
        if seg[0] == CIRCUIT:
            _, rids, stall_counts, du, busy_keys, ej = seg
            s = dep_t
            for r in rids:
                f = free[r]
                if f > s:
                    s = f
            e = s + du
            for r in rids:
                free[r] = e
            if stall_counts:
                span = e - s
                for cnt in stall_counts:
                    st_out.append(cnt * span)
            if busy_keys:
                span = e - s
                for k in busy_keys:
                    bus_busy[k] += span
            mv_out.append(du)
            if rec_segs is not None:
                rec_segs.append((i, _sk, -1, s, e))
        else:
            (_, leg1, leg2, leg3, drain, transit, fill, drain1,
             transit1, fill1, mb, busy_keys, ej) = seg
            s1 = dep_t
            for r in leg1:
                f = free[r]
                if f > s1:
                    s1 = f
            e1 = s1 + drain
            for r in leg1:
                free[r] = e1
            s2 = s1 + drain1
            for r in leg2:
                f = free[r]
                if f > s2:
                    s2 = f
            e2 = s2 + transit
            for r in leg2:
                free[r] = e2
            for k in busy_keys:
                bus_busy[k] += transit
            s3 = s2 + transit1
            for r in leg3:
                f = free[r]
                if f > s3:
                    s3 = f
            e = s3 + fill
            alt = e2 + fill1
            if alt > e:
                e = alt
            for r in leg3:
                free[r] = e
            mv_out.append(mb)
            if rec_segs is not None:
                rec_segs.append((i, _sk, 0, s1, e1))
                rec_segs.append((i, _sk, 1, s2, e2))
                rec_segs.append((i, _sk, 2, s3, e))
        if ej:
            energy += ej
        if e > end:
            end = e
    return end, energy


def _claim_tokens(claim, members) -> list:
    toks: list = []
    for i in members:
        c = claim[i]
        if type(c) is int:
            toks.append(c)
        else:
            toks.extend(c)
    return toks


# --- the vectorized event loop ---------------------------------------------------


def advance(session, until: float | None = None, *,
            stop_on_completion: bool = False) -> list[int]:
    """Vectorized counterpart of ``EngineSession.advance`` (same contract)."""
    hz = _INF if until is None else until
    dev = session.device
    heap = session._heap
    free = session.free
    exec_plan = session._exec_plan
    n_tasks = len(exec_plan)
    ready = session._v_ready.a
    indeg = session._v_indeg.a
    finish = session._v_finish.a
    dur = session._v_dur.a
    tok_ip = session._v_tok_indptr.a
    tok_flat = session._v_tok_flat.a
    sg_ip = session._v_sg_indptr.a
    sg_cnt = session._v_sg_cnt.a
    succ_ip = session._v_succ_indptr.a
    succ_flat = session._v_succ_flat.a
    M = session._v_M.a
    simple = session._v_simple.a
    tok0 = session._v_tok0.a
    claim = session._v_claim
    M_l = session._v_M_l
    simple_l = session._v_simple_l
    tok_ip_l = session._v_tok_indptr_l
    sg_ip_l = session._v_sg_indptr_l
    succ_ip_l = session._v_succ_indptr_l
    succ_flat_l = session._v_succ_flat_l
    neg_cp = session._neg_cp
    guids = session._guids
    job_of = session._job_of
    job_rem = session._job_rem
    job_fin = session._job_fin
    single_job = len(session._job_admit) == 1
    rq = session._rq
    rq_toks = session._v_rq_toks
    rq_bounds = session._v_rq_bounds
    spec = session.refresh
    op_busy = session._op_busy
    move_busy = session._move_busy
    stall = session._stall
    energy = session._energy
    bus_busy = session._bus_busy
    refresh_ns = session._refresh_ns
    n_refresh = session._n_refresh
    completed = session._completed_backlog
    session._completed_backlog = []
    n_exec = 0

    rec = session.recorder
    prof = session.profile
    observe = rec is not None or prof is not None
    rec_tasks = rec._tasks if rec is not None else None
    rec_segs = rec._segs if rec is not None else None
    probes = vec_probes = n_batches = n_batched = heap_saved = n_wide = 0
    if prof is not None:
        _wall0 = time.perf_counter()
        _heap0 = len(heap)
        _refresh0 = n_refresh

    heappush, heappop = heapq.heappush, heapq.heappop
    # the frontier is a *lexicographically sorted list* of the scalar
    # loop's heap tuples — a sorted list satisfies the heap invariant, and
    # sortedness turns batch formation into an index scan over a prefix
    # (no per-member heappop).  Admits append unsorted (dirty flag);
    # Timsort re-sorts adaptively: after `del heap[:k]` the remainder is
    # one sorted run, and each batch only appends its successor pushes
    need_sort = session._heap_dirty
    session._heap_dirty = False
    probe0 = 64       # adaptive vector-formation window start
    # column cache over the sorted frontier, on the device: when the
    # previous batch pushed nothing, the frontier only shrinks from the
    # front, so its key columns can be copied over once and windowed by
    # offset
    cvalid = False
    prev_pushed = True
    coff = 0
    ck0 = ck1 = cpos = None
    while heap:
        if completed and stop_on_completion:
            break
        if need_sort:
            heap.sort()
            need_sort = False
            cvalid = False
        pushed = False
        h = heap[0]
        if h[1] >= hz:
            break

        # --- batch formation: a provably-independent sorted prefix -------
        i0 = h[3]
        # with refresh pending, ready times are read from the device
        # ahead of the scan (rp[j] is heap[j]'s)
        rp: list = []
        if rq:
            _ready_ahead(ready, heap, rp, 0, dev)
            dep0 = rp[0]
            if rq[0][0] <= dep0:
                # the schedule frontier passed refresh due times: apply
                # each unit's CIRCUIT claim (floored at its due time) and
                # requeue
                rint = spec.interval_ns
                rdur = spec.duration_ns
                while rq and rq[0][0] <= dep0:
                    due, u, toks = heappop(rq)
                    b = rq_bounds[u]
                    if b is None:
                        ta = rq_toks[u]
                        fm = float(free[ta].max())
                    else:
                        fm = float(free[b[0]:b[1]].max())
                    s = due if due > fm else fm
                    e = s + rdur
                    k = 1
                    if rec is None:
                        # collapse this unit's further windows already past
                        # the frontier that start clean (due' >= e): after
                        # a refresh every token equals e, so the next
                        # window's floor-max is a comparison, not a reduce.
                        # Unit token sets are disjoint and refresh_ns
                        # accrues a constant, so taking them out of
                        # cross-unit due order is bit-exact — only the
                        # recorder observes the order, hence the gate
                        nxt = due + rint
                        while nxt <= dep0 and nxt >= e:
                            due = nxt
                            e = due + rdur
                            k += 1
                            nxt = due + rint
                    else:
                        rec._refresh.append((u, float(s), float(e)))
                    if b is None:
                        free[ta] = e
                    else:
                        free[b[0]:b[1]] = e
                    n_refresh += k
                    # one add per window: += of a constant depends only on
                    # the add count, matching the scalar accumulator
                    for _ in range(k):
                        refresh_ns += rdur
                    heappush(rq, (due + rint, u, toks))
        rq_due = rq[0][0] if rq else _INF
        no_rq = rq_due == _INF
        members = [i0]
        append = members.append
        toks0 = claim[i0]
        seen = {toks0} if type(toks0) is int else set(toks0)
        seen_add = seen.add
        min_m = M_l[i0]
        W = len(heap)
        if W > BATCH_CAP:
            W = BATCH_CAP
        k = 1
        mem = None
        if stop_on_completion:
            sjobs = {job_of[i0]: 1}
            if job_rem[job_of[i0]] != 1:
                while k < W:
                    hk = heap[k]
                    # heap-order safety: anything drained members push has
                    # key first-component >= min_m; strictly smaller means
                    # this candidate is still the scalar loop's next pop
                    if hk[0] >= min_m or hk[1] >= hz:
                        break
                    pos = hk[3]
                    if not no_rq:
                        if k >= len(rp):
                            _ready_ahead(ready, heap, rp, k, dev)
                        if rq_due <= rp[k]:
                            break
                    toks = claim[pos]
                    if type(toks) is int:
                        if toks in seen:
                            break
                        seen_add(toks)
                    else:
                        if not seen.isdisjoint(toks):
                            break
                        seen.update(toks)
                    m = M_l[pos]
                    if m < min_m:
                        min_m = m
                    append(pos)
                    k += 1
                    j = job_of[pos]
                    c = sjobs.get(j, 0) + 1
                    sjobs[j] = c
                    if job_rem[j] == c:
                        break
        else:
            # a short scalar scan sizes the batch cheaply; if it hits the
            # switch bound without a cut the frontier is wide, and the
            # same cuts are re-evaluated as tensor masks on the device
            # over a window that grows geometrically until one fires
            quick = SCALAR_K if W > SCALAR_K else W
            if not no_rq and quick > len(rp):
                _ready_ahead(ready, heap, rp, quick - 1, dev)
            while k < quick:
                hk = heap[k]
                if hk[0] >= min_m or hk[1] >= hz:
                    break
                pos = hk[3]
                if not no_rq and rq_due <= rp[k]:
                    break
                toks = claim[pos]
                if type(toks) is int:
                    if toks in seen:
                        break
                    seen_add(toks)
                else:
                    if not seen.isdisjoint(toks):
                        break
                    seen.update(toks)
                m = M_l[pos]
                if m < min_m:
                    min_m = m
                append(pos)
                k += 1
            if k == quick and quick < W \
                    and all(simple_l[i] for i in members):
                if not cvalid and not prev_pushed:
                    # stable frontier: copy its columns to the device
                    # once; until something is pushed, later batches
                    # window them by offset instead of re-extracting
                    cols = list(zip(*heap))
                    ck0 = torch.tensor(cols[0], dtype=_F64).to(dev)
                    ck1 = torch.tensor(cols[1], dtype=_F64).to(dev)
                    cpos = torch.tensor(cols[3], dtype=_I64).to(dev)
                    coff = 0
                    cvalid = True
                probe = probe0
                while True:
                    if probe > W:
                        probe = W
                    if cvalid:
                        k0 = ck0[coff:coff + probe]
                        k1v = ck1[coff:coff + probe]
                        pos_a = cpos[coff:coff + probe]
                    else:
                        cols = list(zip(*heap[:probe]))
                        k0 = torch.tensor(cols[0], dtype=_F64).to(dev)
                        k1v = None
                        pos_a = torch.tensor(cols[3], dtype=_I64).to(dev)
                    viol = torch.zeros(probe, dtype=torch.bool, device=dev)
                    # running-min safety bound: candidate j checks against
                    # min(M) over the accepted 0..j-1 prefix
                    minacc = torch.cummin(M[pos_a], 0).values
                    viol[1:] = k0[1:] >= minacc[:-1]
                    viol |= ~simple[pos_a]
                    if hz != _INF:
                        if k1v is None:
                            k1v = torch.tensor(cols[1], dtype=_F64).to(dev)
                        viol |= k1v >= hz
                    if not no_rq:
                        viol |= rq_due <= ready[pos_a]
                    # token conflicts: every simple candidate claims one
                    # token, so a conflict is a duplicate — mark each
                    # repeat occurrence (stable sort keeps window order)
                    t_a = tok0[pos_a]
                    order = torch.argsort(t_a, stable=True)
                    st = t_a[order]
                    rep = order[1:]
                    viol[rep] = viol[rep] | (st[1:] == st[:-1])
                    # the first violation, or ``probe`` if none: one read
                    first = int(torch.where(
                        viol.any(), torch.argmax(viol.to(torch.uint8)),
                        probe))
                    if first < probe:
                        k = first
                        break
                    if probe >= W:
                        k = probe
                        break
                    probe <<= 3
                probe0 = 64 if k < 32 else (
                    BATCH_CAP if k >= BATCH_CAP // 2 else 2 * k)
                if k < W and not simple_l[heap[k][3]]:
                    # the window stopped at a multi-token move, but the
                    # scalar scan can keep batching via set disjointness —
                    # resume it with state rebuilt from the accepted prefix
                    # (the same facts, from the host lists)
                    members = [hh[3] for hh in heap[:k]]
                    append = members.append
                    seen = set(_claim_tokens(claim, members))
                    seen_add = seen.add
                    min_m = min(M_l[i] for i in members)
                    while k < W:
                        hk = heap[k]
                        if hk[0] >= min_m or hk[1] >= hz:
                            break
                        pos = hk[3]
                        if not no_rq:
                            if k >= len(rp):
                                _ready_ahead(ready, heap, rp, k, dev)
                            if rq_due <= rp[k]:
                                break
                        toks = claim[pos]
                        if type(toks) is int:
                            if toks in seen:
                                break
                            seen_add(toks)
                        else:
                            if not seen.isdisjoint(toks):
                                break
                            seen.update(toks)
                        m = M_l[pos]
                        if m < min_m:
                            min_m = m
                        append(pos)
                        k += 1
                else:
                    mem = pos_a[:k]
                    members = [hh[3] for hh in heap[:k]]
        del heap[:k]
        if cvalid:
            coff += k

        if k <= SCALAR_K:
            # small-batch fast path: the batch's token free times, ready
            # times and successors' state come to the host in one copy;
            # the members execute one by one the way the scalar oracle
            # does (same IEEE operations, successor pushes interleaved),
            # and the new state goes back in one write
            toks = _claim_tokens(claim, members)
            succ_seen: dict = {}
            for i in members:
                for sc in succ_flat_l[succ_ip_l[i]:succ_ip_l[i + 1]]:
                    succ_seen[sc] = None
            sl = list(succ_seen)
            nt, nm, ns = len(toks), len(members), len(sl)
            got = _fetch(((free, toks), (ready, members), (ready, sl),
                          (indeg, sl)), dev)
            fh = dict(zip(toks, got[:nt]))
            rdy = dict(zip(sl, got[nt + nm:nt + nm + ns]))
            ind = dict(zip(sl, (int(x) for x in got[nt + nm + ns:])))
            fin_l = []
            for mi, i0 in enumerate(members):
                dep0 = got[nt + mi]
                p = exec_plan[i0]
                lp = len(p)
                if lp == 1:
                    mv_out: list = []
                    st_out: list = []
                    e, energy = _exec_general(p, dep0, fh, bus_busy,
                                              energy, mv_out, st_out,
                                              rec_segs, i0)
                    for du in mv_out:
                        move_busy += du
                    for sv in st_out:
                        stall += sv
                    if observe:
                        probes += len(claim[i0])
                elif lp == 2:
                    rid, du = p
                    f = fh[rid]
                    s = f if f > dep0 else dep0
                    e = s + du
                    fh[rid] = e
                    op_busy += du
                    if observe:
                        probes += 1
                        if rec_tasks is not None:
                            rec_tasks.append((i0, s, e))
                else:
                    rids, stall_counts, du = p
                    s = dep0
                    for r in rids:
                        f = fh[r]
                        if f > s:
                            s = f
                    e = s + du
                    for r in rids:
                        fh[r] = e
                    move_busy += du
                    if stall_counts:
                        span = e - s
                        for cnt in stall_counts:
                            stall += cnt * span
                    if observe:
                        probes += len(rids)
                        if rec_tasks is not None:
                            rec_tasks.append((i0, s, e))
                fin_l.append(e)
                a = succ_ip_l[i0]
                b = succ_ip_l[i0 + 1]
                if b > a:
                    push_items = []
                    for sc in succ_flat_l[a:b]:
                        if rdy[sc] < e:
                            rdy[sc] = e
                        nd = ind[sc] - 1
                        ind[sc] = nd
                        if not nd:
                            push_items.append((neg_cp[sc], e,
                                               guids[sc], sc))
                    if push_items:
                        heap_saved += len(push_items)
                        pushed = True
                        cvalid = False
                        if not need_sort \
                                and len(push_items) << 5 < len(heap):
                            for it in push_items:
                                insort(heap, it)
                        else:
                            heap.extend(push_items)
                            need_sort = True
                j = 0 if single_job else job_of[i0]
                if job_fin[j] < e:
                    job_fin[j] = e
                rem = job_rem[j] - 1
                job_rem[j] = rem
                if not rem:
                    completed.append(j)
                    if rec is not None:
                        rec._jobdone.append((j, job_fin[j]))
            _store(((free, toks, [fh[t] for t in toks]),
                    (finish, members, fin_l),
                    (ready, sl, [rdy[sc] for sc in sl]),
                    (indeg, sl, [ind[sc] for sc in sl])), dev)
            n_exec += k
            n_batches += 1
            if k > 1:
                n_batched += k
            prev_pushed = pushed
            continue

        # --- execute the batch on the device -----------------------------
        if mem is None:
            mem = torch.tensor(members, dtype=_I64).to(dev)
        deps = ready[mem]
        gen = [len(exec_plan[i]) == 1 for i in members]
        has_gen = any(gen)
        ends = torch.empty(k, dtype=_F64, device=dev)
        gen_results: list = []
        if has_gen:
            # general multi-segment moves run per member on a host copy
            # of their tokens (token disjointness makes any execution
            # order exact); their accounting contributions merge back in
            # member order below
            gsel = [j for j in range(k) if gen[j]]
            gi = [members[j] for j in gsel]
            gtoks = _claim_tokens(claim, gi)
            got = _fetch(((free, gtoks), (ready, gi)), dev)
            fh = dict(zip(gtoks, got[:len(gtoks)]))
            g_ends = []
            for gj, i in enumerate(gi):
                mv_out = []
                st_out = []
                e, energy = _exec_general(
                    exec_plan[i], got[len(gtoks) + gj], fh, bus_busy,
                    energy, mv_out, st_out, rec_segs, i)
                g_ends.append(e)
                gen_results.append((mv_out, st_out))
                if observe:
                    probes += len(claim[i])
            _store(((free, gtoks, [fh[t] for t in gtoks]),), dev)
            ends[torch.tensor(gsel, dtype=_I64).to(dev)] = torch.tensor(
                g_ends, dtype=_F64).to(dev)
            cl_sel_l = [j for j in range(k) if not gen[j]]
            cl_list = [members[j] for j in cl_sel_l]
            cl_sel = torch.tensor(cl_sel_l, dtype=_I64).to(dev)
            cl = mem[cl_sel]
            cdeps = deps[cl_sel]
        else:
            cl_sel = None
            cl_list = members
            cl = mem
            cdeps = deps

        st_contrib = None
        s = e = None
        if cl_list:
            n_cl = len(cl_list)
            total = sum(tok_ip_l[i + 1] - tok_ip_l[i] for i in cl_list)
            starts_i = tok_ip[cl]
            counts = tok_ip[cl + 1] - starts_i
            seg_starts = torch.cumsum(counts, 0) - counts
            seg = torch.repeat_interleave(
                torch.arange(n_cl, dtype=_I64, device=dev), counts,
                output_size=total)
            gather = tok_flat[(starts_i - seg_starts)[seg]
                              + torch.arange(total, dtype=_I64, device=dev)]
            permax = torch.zeros(n_cl, dtype=_F64, device=dev)
            permax.scatter_reduce_(0, seg, free[gather], "amax",
                                   include_self=False)
            s = torch.maximum(cdeps, permax)
            e = s + dur[cl]
            free[gather] = e[seg]
            if cl_sel is None:
                ends[:] = e
            else:
                ends[cl_sel] = e
            g_total = sum(sg_ip_l[i + 1] - sg_ip_l[i] for i in cl_list)
            if g_total:
                span = e - s
                g_starts = sg_ip[cl]
                gcounts = sg_ip[cl + 1] - g_starts
                gseg = torch.cumsum(gcounts, 0) - gcounts
                gown = torch.repeat_interleave(
                    torch.arange(n_cl, dtype=_I64, device=dev), gcounts,
                    output_size=g_total)
                g_gather = (g_starts - gseg)[gown] \
                    + torch.arange(g_total, dtype=_I64, device=dev)
                # one rounding here, one for the host's add
                st_contrib = sg_cnt[g_gather] * span[gown]
            if observe:
                probes += total
                vec_probes += total
        finish[mem] = ends

        # --- successors: ready-time maxes, indeg, new frontier entries ---
        n_edges = sum(succ_ip_l[i + 1] - succ_ip_l[i] for i in members)
        succ_part = None
        if n_edges:
            s_start = succ_ip[mem]
            s_cnt = succ_ip[mem + 1] - s_start
            eseg = torch.cumsum(s_cnt, 0) - s_cnt
            eown = torch.repeat_interleave(
                torch.arange(k, dtype=_I64, device=dev), s_cnt,
                output_size=n_edges)
            occ = succ_flat[(s_start - eseg)[eown]
                            + torch.arange(n_edges, dtype=_I64, device=dev)]
            occ_end = ends[eown]
            order = torch.argsort(occ, stable=True)
            so = occ[order]
            se = occ_end[order]
            bound = torch.ones(n_edges, dtype=torch.bool, device=dev)
            bound[1:] = so[1:] != so[:-1]
            grp_first = torch.nonzero(bound).flatten()
            n_grp = len(grp_first)
            gid = torch.cumsum(bound.to(_I64), 0) - 1
            uniq = so[grp_first]
            gmax = torch.zeros(n_grp, dtype=_F64, device=dev)
            gmax.scatter_reduce_(0, gid, se, "amax", include_self=False)
            ready[uniq] = torch.maximum(ready[uniq], gmax)
            grp_last = torch.empty(n_grp, dtype=_I64, device=dev)
            grp_last[:-1] = grp_first[1:]
            grp_last[-1] = n_edges
            dec = grp_last - grp_first
            grp_last -= 1
            nd = indeg[uniq] - dec
            indeg[uniq] = nd
            # the scalar loop keys each push with the end of the member
            # that zeroed the indegree — the successor's last in-batch
            # dependency in member order (the stable sort preserves it)
            succ_part = (uniq.to(_F64), nd.to(_F64), se[grp_last])

        # --- the batch's one copy back: ends, stall terms, pushes --------
        parts = [ends]
        if st_contrib is not None:
            parts.append(st_contrib)
        if succ_part is not None:
            parts.extend(succ_part)
        if rec_tasks is not None and cl_list:
            parts.extend((s, e))
        host = torch.cat(parts).tolist()
        ends_l = host[:k]
        o = k
        st_l = []
        if st_contrib is not None:
            st_l = host[o:o + len(st_contrib)]
            o += len(st_contrib)
        if succ_part is not None:
            uniq_l = host[o:o + n_grp]
            nd_l = host[o + n_grp:o + 2 * n_grp]
            pr_l = host[o + 2 * n_grp:o + 3 * n_grp]
            o += 3 * n_grp
        if rec_tasks is not None and cl_list:
            sl_ = host[o:o + len(cl_list)]
            el_ = host[o + len(cl_list):o + 2 * len(cl_list)]
            for ci, i in enumerate(cl_list):
                rec_tasks.append((i, sl_[ci], el_[ci]))

        # accumulators, left to right in member order
        cl_plan = [exec_plan[i] for i in cl_list]
        op_busy = _seqsum(op_busy, [p[1] for p in cl_plan if len(p) == 2])
        if not has_gen:
            move_busy = _seqsum(move_busy,
                                [p[2] for p in cl_plan if len(p) == 3])
            stall = _seqsum(stall, st_l)
        else:
            # merge move-busy / stall contributions back into member order
            mv_seq: list = []
            st_seq: list = []
            ci = sti = 0
            g_iter = iter(gen_results)
            for j in range(k):
                if gen[j]:
                    mv_o, st_o = next(g_iter)
                    mv_seq.extend(mv_o)
                    st_seq.extend(st_o)
                else:
                    i = cl_list[ci]
                    p = cl_plan[ci]
                    if len(p) == 3:
                        mv_seq.append(p[2])
                    gc = sg_ip_l[i + 1] - sg_ip_l[i]
                    if gc:
                        st_seq.extend(st_l[sti:sti + gc])
                        sti += gc
                    ci += 1
            move_busy = _seqsum(move_busy, mv_seq)
            stall = _seqsum(stall, st_seq)

        if succ_part is not None:
            items = [(neg_cp[int(u)], pr, guids[int(u)], int(u))
                     for u, ndv, pr in zip(uniq_l, nd_l, pr_l) if ndv == 0]
            if items:
                # frontier content (a set keyed by total-order tuples) is
                # what the prefix scan observes, so the insert strategy is
                # invisible to ordering: few pushes binary-insert, many
                # are sorted and bulk-appended as one ascending run, which
                # the next adaptive Timsort merges in near-linear time
                npush = len(items)
                heap_saved += npush
                pushed = True
                cvalid = False
                if not need_sort and npush << 5 < len(heap):
                    for it in items:
                        insort(heap, it)
                else:
                    items.sort()
                    heap.extend(items)
                    need_sort = True

        # --- job bookkeeping ---------------------------------------------
        if single_job:
            mx = max(ends_l)
            if job_fin[0] < mx:
                job_fin[0] = mx
            rem = job_rem[0] - k
            job_rem[0] = rem
            if not rem:
                completed.append(0)
                if rec is not None:
                    rec._jobdone.append((0, job_fin[0]))
        else:
            for idx, i in enumerate(members):
                end = ends_l[idx]
                j = job_of[i]
                if job_fin[j] < end:
                    job_fin[j] = end
                rem = job_rem[j] - 1
                job_rem[j] = rem
                if not rem:
                    completed.append(j)
                    if rec is not None:
                        rec._jobdone.append((j, job_fin[j]))
        n_exec += k
        n_batches += 1
        n_wide += 1
        if k > 1:
            n_batched += k
        prev_pushed = pushed

    # pushes appended but not yet sorted in stay flagged for the next call
    session._heap_dirty = need_sort
    session._n_live -= n_exec
    if not heap and session._n_live:
        raise RuntimeError("engine deadlock: not all tasks executed "
                           "(graph validation should have caught this)")
    session._op_busy = op_busy
    session._move_busy = move_busy
    session._stall = stall
    session._energy = energy
    session._refresh_ns = refresh_ns
    session._n_refresh = n_refresh
    advance.batches += n_batches
    advance.wide_batches += n_wide
    if prof is not None:
        prof.record_advance(
            wall_s=time.perf_counter() - _wall0, n_exec=n_exec,
            heap_pushes=len(heap) - _heap0 + n_exec,
            token_probes=probes,
            refresh_windows=n_refresh - _refresh0,
            batches=n_batches, batched_tasks=n_batched,
            vector_probes=vec_probes, heap_ops_avoided=heap_saved)
    if until is None:
        mx = float(finish[:n_tasks].max()) if n_tasks else 0.0
        if mx > session.now:
            session.now = mx
    elif until > session.now:
        session.now = until
    return completed


# process-wide dispatch counters, in the manner of the kernels' launch
# counts: every batch (``batches``, what the profile hook's ``batches``
# sums) and the batches wider than SCALAR_K that run as device gathers and
# scatters (``wide_batches``)
advance.batches = 0
advance.wide_batches = 0
