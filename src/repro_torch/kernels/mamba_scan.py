"""Selective scan: the wrappers around the Hopper kernel.

Replaces ``repro/kernels/mamba_scan.py::mamba_scan`` (Pallas TPU).  The
kernel is CUDA C++ in ``csrc/mamba_scan.cu``, built by ``_build`` and called
through its C interface, with these entry points:

* ``mamba_scan(decay, u, c)``: the TPU kernel's contract, any ``T``;
* ``selective_scan(dt, x, b, c, A, h0)``: the fused Mamba-1 form that
  ``models/ssm.py::mamba1_block`` calls, which builds decay and u in
  registers and never stores the (B, T, D, N) products;
* ``selective_scan_bwd(dt, x, b, c, A, h0, dy, dh_last)``: the Mamba-1
  form's gradient, whose plain counterpart is ``ref.selective_scan_bwd_ref``:
  a reverse-time walk on the CUDA cores over states it recomputes, its
  inputs through a ring of whole chunks loaded by TMA;
* ``mamba2_scan(dt, x, b, c, A, h0)``: the Mamba-2 form that
  ``models/ssm.py::mamba2_block`` calls: a scalar decay a head, b and c
  shared by every head, a (P, N) state a head.  A bf16 prefill runs as the
  chunked (SSD) form on the tensor cores, whose plain counterpart is
  ``ref.mamba2_scan_chunked_ref``;
* ``mamba2_scan_bwd(dt, x, b, c, A, h0, dy, dh_last)``: the Mamba-2 form's
  gradient, whose plain counterpart is ``ref.mamba2_scan_bwd_ref``.  A bf16
  call runs as the chunked (SSD) form's backward on the tensor cores
  (``ref.mamba2_scan_chunked_bwd_ref``, stage by stage), the others as a
  reverse-time walk over recomputed states on the CUDA cores.

A tensor on the CPU goes to the plain versions in ``ref``; a CUDA tensor
goes to the kernel or the call raises.  Under grad mode with an input that
requires grad, ``selective_scan`` and ``mamba2_scan`` run the
``repro_torch::selective_scan`` and ``repro_torch::mamba2_scan`` custom ops,
whose autograd formulas are the ``repro_torch::selective_scan_bwd`` and
``repro_torch::mamba2_scan_bwd`` ops (all dispatcher ops, so that selective
activation checkpointing sees the scans and recomputes them); each forward
saves only its inputs.  ``mamba_scan``, which no model differentiates (the
reference's Pallas kernel defines no VJP), has no backward: on a card it
raises under grad rather than return an output that autograd cannot follow.
``mamba_scan.launches``, ``selective_scan.launches``,
``selective_scan_bwd.launches``, ``mamba2_scan.launches`` and
``mamba2_scan_bwd.launches`` count kernel launches (a backward call is one
count for its three to six launches).  ``selective_plan``,
``selective_scan_bwd_plan`` and ``mamba2_bwd_plan`` mirror how the kernel's
host code runs a Mamba-1 call (lanes a channel, direct or ring path, TMA or
lane loads, grid), a Mamba-1 backward (lanes, channel blocks, chunks, the
ring's depth, shared memory, scratch, TMA or thread loads) and a Mamba-2
backward (path, lanes, rows, scratch), so that the
choice can be tested without a card; ``kernel_plan``,
``kernel_selective_scan_bwd_plan``, ``kernel_mamba2_plan`` and
``kernel_mamba2_bwd_plan`` ask the built library.

A DTensor or fake input goes to the ops too (``_symbolic``); each op has a
fake implementation and a DTensor sharding rule (at the end of this file).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding

from repro_torch.kernels import _build, _symbolic
from repro_torch.kernels.ref import (mamba2_scan_bwd_ref, mamba2_scan_ref,
                                     mamba_scan_ref, selective_scan_bwd_ref,
                                     selective_scan_ref)

MAX_STATE = 128                 # N: 8 lanes of 16 states each
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# csrc/mamba_scan.cu's plan_selective and its constants
RING_THREADS = 256              # NC: consumer threads a ring block
DIRECT_T = 8                    # the longest T run without the ring
DIRECT_THREADS = 128            # threads a direct-path block


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mamba_scan").lib
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mamba_scan_fwd.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.mamba_scan_fwd.restype = i
    lib.selective_scan_fwd.argtypes = [p] * 8 + [i] * 5 + [ll] * 8 + [p]
    lib.selective_scan_fwd.restype = i
    lib.selective_scan_plan.argtypes = [p] * 8 + [i] * 5 + [ll] * 8 + [p]
    lib.selective_scan_plan.restype = i
    lib.selective_scan_bwd.argtypes = ([p] * 15 + [ll] + [i] * 5 + [ll] * 8
                                       + [p])
    lib.selective_scan_bwd.restype = i
    lib.selective_scan_bwd_plan.argtypes = [p] * 5 + [i] * 5 + [ll] * 8 + [p]
    lib.selective_scan_bwd_plan.restype = i
    lib.mamba2_scan_fwd.argtypes = [p] * 8 + [i] * 6 + [ll] * 9 + [p]
    lib.mamba2_scan_fwd.restype = i
    lib.mamba2_scan_plan.argtypes = [p] * 8 + [i] * 6 + [ll] * 9 + [p]
    lib.mamba2_scan_plan.restype = i
    lib.mamba2_scan_bwd.argtypes = [p] * 15 + [ll] + [i] * 6 + [ll] * 9 + [p]
    lib.mamba2_scan_bwd.restype = i
    lib.mamba2_scan_bwd_plan.argtypes = [i] * 6 + [p]
    lib.mamba2_scan_bwd_plan.restype = i
    lib.ms_error_string.argtypes = [i]
    lib.ms_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err} "
                           f"({_lib().ms_error_string(err).decode()})")


def _refuse_grad(what: str, *ts: torch.Tensor) -> None:
    """A kernel without a backward, on a card, under grad: raise rather
    than return an output that autograd cannot follow."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            f"{what} has no backward kernel (no model differentiates it; the "
            "models' Mamba-1 path is selective_scan): call it under "
            "torch.no_grad() or on the CPU")


def _check_state(N: int) -> None:
    if not 0 < N <= MAX_STATE:
        raise ValueError(f"state size {N}: the kernel takes 1..{MAX_STATE}")


def _check_scan(decay, u, c):
    if decay.dim() != 4 or u.shape != decay.shape:
        raise ValueError(f"want decay, u (B,T,D,N) alike; got "
                         f"{tuple(decay.shape)}, {tuple(u.shape)}")
    B, T, D, N = decay.shape
    if tuple(c.shape) != (B, T, N):
        raise ValueError(f"c {tuple(c.shape)} != (B, T, N) {(B, T, N)}")
    if min(B, T, D) == 0:
        raise ValueError("empty input")
    _check_state(N)
    if not (decay.device == u.device == c.device):
        raise ValueError("decay, u, c on different devices")
    for name, t in (("decay", decay), ("u", u), ("c", c)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}: the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def mamba_scan(decay: torch.Tensor, u: torch.Tensor, c: torch.Tensor
               ) -> torch.Tensor:
    """decay, u: (B, T, D, N); c: (B, T, N) -> y: (B, T, D) float32.

    ``y_t = c_t . h_t`` with ``h_t = decay_t * h_{t-1} + u_t``, ``h_{-1}=0``.
    """
    if decay.device.type == "cpu":
        return mamba_scan_ref(decay, u, c)
    if decay.device.type != "cuda":
        raise ValueError(f"unsupported device {decay.device}")
    _refuse_grad("mamba_scan", decay, u, c)
    _check_scan(decay, u, c)
    B, T, D, N = decay.shape
    y = torch.empty((B, T, D), dtype=torch.float32, device=decay.device)
    with torch.cuda.device(decay.device):
        stream = torch.cuda.current_stream(decay.device).cuda_stream
        err = _lib().mamba_scan_fwd(decay.data_ptr(), u.data_ptr(),
                                    c.data_ptr(), y.data_ptr(), B, T, D, N,
                                    stream)
    _raise_on(err, "mamba_scan")
    mamba_scan.launches += 1
    return y


mamba_scan.launches = 0


def _check_selective(dt, x, b, c, A, h0):
    if dt.dim() != 3 or x.shape != dt.shape:
        raise ValueError(f"want dt, x (B,T,D) alike; got {tuple(dt.shape)}, "
                         f"{tuple(x.shape)}")
    B, T, D = dt.shape
    if b.dim() != 3 or b.shape[:2] != (B, T) or c.shape != b.shape:
        raise ValueError(f"want b, c (B,T,N); got {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    N = b.shape[2]
    if tuple(A.shape) != (D, N) or tuple(h0.shape) != (B, D, N):
        raise ValueError(f"want A (D,N) {(D, N)}, h0 (B,D,N) {(B, D, N)}; "
                         f"got {tuple(A.shape)}, {tuple(h0.shape)}")
    if min(B, T, D) == 0:
        raise ValueError("empty input")
    _check_state(N)
    if len({t.device for t in (dt, x, b, c, A, h0)}) != 1:
        raise ValueError("inputs on different devices")
    for name, t in (("dt", dt), ("A", A), ("h0", h0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}: the kernel takes float32")
    if not (x.dtype == b.dtype == c.dtype) or x.dtype not in _DTYPES:
        raise TypeError(f"x, b, c are {x.dtype}, {b.dtype}, {c.dtype}: the "
                        "kernel takes float32 or bfloat16, all alike")
    for name, t in (("dt", dt), ("x", x), ("b", b), ("c", c)):
        if t.stride(2) != 1:
            raise ValueError(f"{name} needs a unit stride on its last axis; "
                             f"strides {t.stride()}")
    for name, t in (("A", A), ("h0", h0)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@dataclasses.dataclass(frozen=True)
class Plan:
    """How ``selective_scan_fwd`` runs a call."""
    states: int          # S: states a lane holds
    lanes: int           # P: lanes a channel
    channels: int        # CH: channels a ring block
    direct: bool         # T <= DIRECT_T: no ring, inputs read from global
    tma_dt: bool         # dt through TMA (else the producer warp's lanes)
    tma_x: bool          # x through TMA
    vec: bool            # A, h0, h_last as 16-byte vectors
    grid: tuple[int, int]

    def as_ints(self) -> list[int]:
        return [self.states, self.lanes, self.channels, int(self.direct),
                int(self.tma_dt), int(self.tma_x), int(self.vec), *self.grid]


def _tma_ok(t: torch.Tensor) -> bool:
    """A TMA tensor map takes a 16-byte aligned base and batch and time
    strides that are positive multiples of 16 bytes (a size-1 batch's is
    not used)."""
    e = t.element_size()
    sb, st = t.stride(0), t.stride(1)
    return (t.data_ptr() % 16 == 0 and st > 0 and st * e % 16 == 0
            and (t.shape[0] == 1 or (sb > 0 and sb * e % 16 == 0)))


def selective_plan(dt: torch.Tensor, x: torch.Tensor, A: torch.Tensor,
                   h0: torch.Tensor, h_last: torch.Tensor) -> Plan:
    """The plan ``csrc/mamba_scan.cu::plan_selective`` makes for these
    operands (``h_last`` the output the wrapper allocates).

    S = 8 states a lane up to N = 16 (16 above), P = next_pow2(N / S) lanes
    a channel, RING_THREADS / P channels a ring block; T <= DIRECT_T takes
    the direct path, one thread a (channel, lane) in blocks of
    DIRECT_THREADS; the ring path loads dt and x by TMA where ``_tma_ok``.
    """
    B, T, D = dt.shape
    N = A.shape[1]
    S = 8 if N <= 16 else 16
    P = 1
    while S * P < N:
        P *= 2
    direct = T <= DIRECT_T
    vec = N % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (A, h0, h_last))
    if direct:
        grid = (-(-B * D * P // DIRECT_THREADS), 1)
    else:
        grid = (-(-D // (RING_THREADS // P)), B)
    return Plan(S, P, RING_THREADS // P, direct,
                not direct and _tma_ok(dt), not direct and _tma_ok(x), vec,
                grid)


def _selective_args(dt, x, b, c, A, h0, y, h_last) -> list:
    B, T, D = dt.shape
    return [dt.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(),
            A.data_ptr(), h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
            _DTYPES[x.dtype], B, T, D, b.shape[2], dt.stride(0), dt.stride(1),
            x.stride(0), x.stride(1), b.stride(0), b.stride(1), c.stride(0),
            c.stride(1)]


def kernel_plan(dt, x, b, c, A, h0, h_last) -> Plan:
    """The plan the built kernel's host code makes (a card's library)."""
    out = (ctypes.c_int * 9)()
    y = h_last.new_empty(dt.shape)
    _raise_on(_lib().selective_scan_plan(
        *_selective_args(dt, x, b, c, A, h0, y, h_last), out),
        "selective_scan_plan")
    v = list(out)
    return Plan(v[0], v[1], v[2], bool(v[3]), bool(v[4]), bool(v[5]),
                bool(v[6]), (v[7], v[8]))


def selective_scan(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, A: torch.Tensor, h0: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1 selective scan from state ``h0``.

    dt (B, T, D) float32; x (B, T, D), b and c (B, T, N) in float32 or
    bfloat16 (batch and time strides free, so slices of one projection need
    no copy); A (D, N) and h0 (B, D, N) float32.  Returns y (B, T, D) and
    the last state (B, D, N), both float32: ``decay_t = exp(dt_t * A)``,
    ``u_t = (dt_t * x_t) * b_t``, ``h_t = decay_t * h_{t-1} + u_t``,
    ``y_t = sum_n h_t * c_t``.  Differentiable: under grad mode with an
    input that requires grad this is the ``repro_torch::selective_scan``
    op.
    """
    if _symbolic.symbolic(dt, x, b, c, A, h0) or torch.is_grad_enabled() \
            and any(t.requires_grad for t in (dt, x, b, c, A, h0)):
        return tuple(torch.ops.repro_torch.selective_scan(dt, x, b, c, A, h0))
    return _selective_forward(dt, x, b, c, A, h0)


def _selective_forward(dt, x, b, c, A, h0):
    """One forward call: the plain version on the CPU, else one launch."""
    if dt.device.type == "cpu":
        return selective_scan_ref(dt, x, b, c, A, h0)
    if dt.device.type != "cuda":
        raise ValueError(f"unsupported device {dt.device}")
    _check_selective(dt, x, b, c, A, h0)
    B, T, D = dt.shape
    N = b.shape[2]
    y = torch.empty((B, T, D), dtype=torch.float32, device=dt.device)
    h_last = torch.empty((B, D, N), dtype=torch.float32, device=dt.device)
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = _lib().selective_scan_fwd(
            *_selective_args(dt, x, b, c, A, h0, y, h_last), stream)
    _raise_on(err, "selective_scan")
    selective_scan.launches += 1
    return y, h_last


selective_scan.launches = 0


# --- the Mamba-1 backward ----------------------------------------------------

SEL_BWD_THREADS = 128           # csrc's SB_NT: threads a block
SEL_BWD_STATES = 8              # csrc's SB_S: states a lane
SEL_BWD_CHUNK = 16              # csrc's SB_Q: steps a chunk, a ring stage
SEL_BWD_SUB = 4                 # csrc's SB_SC: steps a sub-chunk (level 3)
SEL_BWD_DEPTH = 3               # csrc's SB_DEPTH: ring stages, at most
SEL_BWD_BLOCKS = 4              # csrc's SB_MINB: blocks an SM
SM_SMEM = 233472                # an SM's shared memory, bytes
SEL_BWD_OPERANDS = ("dt", "x", "dy", "b", "c")   # the plan's TMA flags


@dataclasses.dataclass(frozen=True)
class SelectiveBwdPlan:
    """How ``selective_scan_bwd`` runs a call."""
    states: int          # S: states a lane
    lanes: int           # P: lanes a channel
    channels: int        # CH: channels a block
    channel_blocks: int  # NB: blocks a batch row
    chunk: int           # Q: steps a chunk, a stage of the ring
    chunks: int          # chunks of Q steps
    depth: int           # stages of the ring
    smem: int            # the main kernel's shared memory, bytes
    scratch: int         # floats of scratch the call needs
    tma: tuple[bool, ...] = (False,) * 5   # SEL_BWD_OPERANDS through TMA

    def as_ints(self) -> list[int]:
        return [self.states, self.lanes, self.channels, self.channel_blocks,
                self.chunk, self.chunks, self.depth, self.smem,
                self.scratch, *map(int, self.tma)]


def _sel_bwd_smem(CH: int, NP: int, xb: int, q: int, depth: int) -> int:
    """csrc's SbLayout::bytes: the ring's ``depth`` stages of ``q`` steps
    (dt, x, dy a channel; b, c over NP states as f32, and as loaded when
    bf16), the state slots (two chunk-entry slots and one a sub-chunk
    between a chunk's first and last, S floats a thread each), a chunk's
    warp sums of db and dc ([q][warp][2 NP]) and SEL_BWD_DEPTH + 1
    barriers, from a 128-byte boundary."""
    stage = q * (CH * (8 + xb) + NP * (12 if xb == 2 else 8))
    slots = max(q // SEL_BWD_SUB, 2) * SEL_BWD_STATES * SEL_BWD_THREADS
    return (128 + depth * stage + 4 * slots
            + 4 * q * (SEL_BWD_THREADS // 32) * 2 * NP
            + 8 * (SEL_BWD_DEPTH + 1))


def selective_scan_bwd_plan(B: int, T: int, D: int, N: int,
                            dtype: torch.dtype = torch.float32,
                            operands=None) -> SelectiveBwdPlan:
    """The plan ``csrc/mamba_scan.cu::plan_selective_bwd`` makes for x, b,
    c in ``dtype``; ``operands``, (dt, x, b, c, dy) as the kernel gets
    them, give its TMA choices (without them, none).

    S = 8 states a lane, P = next_pow2(N / 8) lanes a channel and
    SEL_BWD_THREADS / P channels a block, one block a channel block and
    batch row.  A chunk, a stage of the ring, is SEL_BWD_CHUNK steps, or
    half of that (not below 8) where even a two-stage ring would not let
    SEL_BWD_BLOCKS blocks share an SM's SM_SMEM bytes (1 KB reserved a
    block; shared memory as ``_sel_bwd_smem`` counts it); the ring is the
    deepest up to SEL_BWD_DEPTH (at least 2) that does.  Scratch: a state
    slot (S floats a thread) a block and chunk, dA's partial sums a batch
    row (B, D, N), and db's and dc's a channel block (B, T, NB, N) each.
    An operand goes
    through TMA where ``_tma_ok`` (dy: the wrapper's contiguous float32),
    else the block's threads load it."""
    S, NT = SEL_BWD_STATES, SEL_BWD_THREADS
    P = 1
    while S * P < N:
        P *= 2
    CH, NP = NT // P, S * P
    xb = 2 if dtype == torch.bfloat16 else 4

    def fits(q, depth):
        return (SEL_BWD_BLOCKS * (_sel_bwd_smem(CH, NP, xb, q, depth) + 1024)
                <= SM_SMEM)

    Q = SEL_BWD_CHUNK
    if SEL_BWD_CHUNK >= 16 and not fits(SEL_BWD_CHUNK, 2):
        Q //= 2
    depth = SEL_BWD_DEPTH
    while depth > 2 and not fits(Q, depth):
        depth -= 1
    NB, chunks = -(-D // CH), -(-T // Q)
    scratch = B * NB * chunks * S * NT + B * D * N + 2 * B * T * NB * N
    tma = (False,) * 5
    if operands is not None:
        dt, x, b, c, dy = operands
        tma = tuple(map(_tma_ok, (dt, x, dy, b, c)))
    return SelectiveBwdPlan(S, P, CH, NB, Q, chunks, depth,
                            _sel_bwd_smem(CH, NP, xb, Q, depth), scratch, tma)


def kernel_selective_scan_bwd_plan(dt, x, b, c, dy) -> SelectiveBwdPlan:
    """The plan the built kernel's host code makes for these operands (dy
    the (B, T, D) float32 it gets), from a card's library."""
    out = (ctypes.c_longlong * 14)()
    args = _selective_args(dt, x, b, c, dt, dt, dt, dt)
    _raise_on(_lib().selective_scan_bwd_plan(
        *args[:4], dy.data_ptr(), *args[8:], out), "selective_scan_bwd_plan")
    v = list(map(int, out))
    return SelectiveBwdPlan(*v[:9], tuple(map(bool, v[9:])))


def selective_scan_bwd(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, A: torch.Tensor, h0: torch.Tensor,
                       dy: torch.Tensor, dh_last: torch.Tensor
                       ) -> tuple[torch.Tensor, ...]:
    """The gradient of ``selective_scan`` at (dt, x, b, c, A, h0) for output
    gradients dy (B, T, D) and dh_last (B, D, N): (ddt (B, T, D) float32,
    dx in x's dtype, db and dc (B, T, N) in b's, dA (D, N) and dh0
    (B, D, N) float32), every output contiguous.  The operands as
    ``selective_scan`` takes them; dy and dh_last are made contiguous
    float32."""
    if dt.device.type == "cpu":
        return selective_scan_bwd_ref(dt, x, b, c, A, h0, dy, dh_last)
    if dt.device.type != "cuda":
        raise ValueError(f"unsupported device {dt.device}")
    _check_selective(dt, x, b, c, A, h0)
    B, T, D = dt.shape
    N = b.shape[2]
    if tuple(dy.shape) != (B, T, D) or dh_last.shape != h0.shape:
        raise ValueError(f"want dy {(B, T, D)}, dh_last {tuple(h0.shape)}; "
                         f"got {tuple(dy.shape)}, {tuple(dh_last.shape)}")
    if not (dy.device == dh_last.device == dt.device):
        raise ValueError("dy, dh_last and the operands on different devices")
    dy = dy.float().contiguous()
    dh_last = dh_last.float().contiguous()
    plan = selective_scan_bwd_plan(B, T, D, N, x.dtype)
    f32, dev = torch.float32, dt.device
    ddt = torch.empty((B, T, D), dtype=f32, device=dev)
    dx = torch.empty((B, T, D), dtype=x.dtype, device=dev)
    db = torch.empty((B, T, N), dtype=b.dtype, device=dev)
    dc = torch.empty((B, T, N), dtype=c.dtype, device=dev)
    dA = torch.empty((D, N), dtype=f32, device=dev)
    dh0 = torch.empty((B, D, N), dtype=f32, device=dev)
    scratch = torch.empty((plan.scratch,), dtype=f32, device=dev)
    args = _selective_args(dt, x, b, c, A, h0, ddt, dh0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().selective_scan_bwd(
            *args[:6], dy.data_ptr(), dh_last.data_ptr(), ddt.data_ptr(),
            dx.data_ptr(), db.data_ptr(), dc.data_ptr(), dA.data_ptr(),
            dh0.data_ptr(), scratch.data_ptr(), plan.scratch, *args[8:],
            stream)
    _raise_on(err, "selective_scan_bwd")
    selective_scan_bwd.launches += 1
    return ddt, dx, db, dc, dA, dh0


selective_scan_bwd.launches = 0


def _check_mamba2(dt, x, b, c, A, h0):
    if dt.dim() != 3 or x.dim() != 4 or x.shape[:3] != dt.shape:
        raise ValueError(f"want dt (B,T,H), x (B,T,H,P); got "
                         f"{tuple(dt.shape)}, {tuple(x.shape)}")
    B, T, H, P = x.shape
    if b.dim() != 3 or b.shape[:2] != (B, T) or c.shape != b.shape:
        raise ValueError(f"want b, c (B,T,N); got {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    N = b.shape[2]
    if tuple(A.shape) != (H,) or tuple(h0.shape) != (B, H, P, N):
        raise ValueError(f"want A (H,) {(H,)}, h0 (B,H,P,N) {(B, H, P, N)}; "
                         f"got {tuple(A.shape)}, {tuple(h0.shape)}")
    if min(B, T, H, P) == 0:
        raise ValueError("empty input")
    if B > 65535 or H > 65535:
        raise ValueError(f"B={B}, H={H}: the kernel's grid takes 65535")
    _check_state(N)
    if len({t.device for t in (dt, x, b, c, A, h0)}) != 1:
        raise ValueError("inputs on different devices")
    for name, t in (("dt", dt), ("A", A), ("h0", h0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}: the kernel takes float32")
    if not (x.dtype == b.dtype == c.dtype) or x.dtype not in _DTYPES:
        raise TypeError(f"x, b, c are {x.dtype}, {b.dtype}, {c.dtype}: the "
                        "kernel takes float32 or bfloat16, all alike")
    for name, t in (("dt", dt), ("x", x), ("b", b), ("c", c)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit stride on its last axis; "
                             f"strides {t.stride()}")
    for name, t in (("A", A), ("h0", h0)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


MAMBA2_PATHS = ("direct", "staged", "chunked")   # csrc's plan codes 0, 1, 2


@dataclasses.dataclass(frozen=True)
class Mamba2Plan:
    """How ``mamba2_scan_fwd`` runs a call."""
    path: str            # "direct": T <= 8 (decode), CUDA cores;
                         # "chunked": the SSD form on the tensor cores
                         # (T > 8, bfloat16 x, b, c, N <= 64);
                         # "staged": CUDA cores, the other T > 8 calls
    lanes: int           # NL: lanes a row group on the CUDA-core paths
                         # (4 rows x 4 states a lane); 0 when chunked
    rows: int            # rows of P a block
    vec: bool            # h0, h_last as 16-byte vectors (CUDA-core paths)
    tma: tuple[bool, bool, bool, bool]  # chunked path: x, b, c in and y
                                        # out through TMA
    grid: tuple[int, int, int]

    def as_ints(self) -> list[int]:
        return [MAMBA2_PATHS.index(self.path), self.lanes, self.rows,
                int(self.vec), *map(int, self.tma), *self.grid]


def _mamba2_args(dt, x, b, c, A, h0, y, h_last) -> list:
    B, T, H, P = x.shape
    return [dt.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(),
            A.data_ptr(), h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
            _DTYPES[x.dtype], B, T, H, P, b.shape[2], dt.stride(0),
            dt.stride(1), x.stride(0), x.stride(1), x.stride(2), b.stride(0),
            b.stride(1), c.stride(0), c.stride(1)]


def kernel_mamba2_plan(dt, x, b, c, A, h0, h_last) -> Mamba2Plan:
    """The plan ``csrc/mamba_scan.cu::plan_mamba2`` makes for these operands
    (``h_last`` the output the wrapper allocates), from a card's library.
    T <= 8 takes the direct path; T > 8 with bfloat16 x, b, c and N <= 64
    the chunked path, 64 rows of P a block, each of x, b, c in through TMA
    where its base and strides allow and y out through it when P % 4 == 0;
    the other calls the staged path.  On the CUDA-core paths a lane holds
    4 rows x 4 states, NL = max(4, next_pow2(N / 4)) lanes a row group and
    4 * 128 / NL rows a 128-thread block.  One block a (row block, head,
    batch row)."""
    out = (ctypes.c_int * 11)()
    y = h_last.new_empty(x.shape)
    _raise_on(_lib().mamba2_scan_plan(
        *_mamba2_args(dt, x, b, c, A, h0, y, h_last), out),
        "mamba2_scan_plan")
    v = list(out)
    return Mamba2Plan(MAMBA2_PATHS[v[0]], v[1], v[2], bool(v[3]),
                      tuple(map(bool, v[4:8])), (v[8], v[9], v[10]))


def mamba2_scan(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, A: torch.Tensor, h0: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 scan from state ``h0``.

    dt (B, T, H) float32; x (B, T, H, P), b and c (B, T, N) in float32 or
    bfloat16 (batch, time and head strides free, so slices of one
    projection need no copy); A (H,) and h0 (B, H, P, N) float32.  Returns
    y (B, T, H, P) and the last state (B, H, P, N), both float32:
    ``decay_t = exp(dt_t * A)`` a head, ``u_t = (dt_t * x_t) * b_t``,
    ``h_t = decay_t * h_{t-1} + u_t``, ``y_t = sum_n h_t * c_t``.
    Differentiable: under grad mode with an input that requires grad this
    is the ``repro_torch::mamba2_scan`` op.
    """
    if _symbolic.symbolic(dt, x, b, c, A, h0) or torch.is_grad_enabled() \
            and any(t.requires_grad for t in (dt, x, b, c, A, h0)):
        return tuple(torch.ops.repro_torch.mamba2_scan(dt, x, b, c, A, h0))
    return _mamba2_forward(dt, x, b, c, A, h0)


def _mamba2_forward(dt, x, b, c, A, h0):
    """One forward call: the plain version on the CPU, else one launch."""
    if dt.device.type == "cpu":
        return mamba2_scan_ref(dt, x, b, c, A, h0)
    if dt.device.type != "cuda":
        raise ValueError(f"unsupported device {dt.device}")
    _check_mamba2(dt, x, b, c, A, h0)
    B, T, H, P = x.shape
    N = b.shape[2]
    y = torch.empty((B, T, H, P), dtype=torch.float32, device=dt.device)
    h_last = torch.empty((B, H, P, N), dtype=torch.float32, device=dt.device)
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = _lib().mamba2_scan_fwd(
            *_mamba2_args(dt, x, b, c, A, h0, y, h_last), stream)
    _raise_on(err, "mamba2_scan")
    mamba2_scan.launches += 1
    return y, h_last


mamba2_scan.launches = 0


# --- the backward -------------------------------------------------------------

BWD_CHUNK = 64                  # csrc's BW_Q (and SSD_Q): steps a chunk
BWD_SUB = 4                     # csrc's BW_SC: steps of the shared history
M2_THREADS = 128                # csrc's M2_NT: threads a block
BWD_HEADS = 20                  # csrc's CB_HEADS: heads a tile block walks
BWD_PATHS = ("cudacore", "chunked")     # csrc's plan codes 0, 1
TILE = 64 * 128                 # csrc's SSD_TILE: a 64 x 64 bf16 tile, bytes
# csrc's CbSmem::SIZE: 9 tiles, dB and dC (4 tiles' bytes of f32), the
# tables and sums (880 + 900 floats), after up to 1024 bytes of alignment
CHUNKED_SMEM = 1024 + 13 * TILE + 4 * (880 + 900)


@dataclasses.dataclass(frozen=True)
class Mamba2BwdPlan:
    """How ``mamba2_scan_bwd`` runs a call."""
    path: str            # "chunked": the SSD form's backward on the tensor
                         # cores (bfloat16 x, b, c, N <= 64, T > 8);
                         # "cudacore": the recomputing walk, the others
    lanes: int           # NL: lanes a row group (4 rows x 4 states a
                         # lane) on the CUDA cores; 0 when chunked
    rows: int            # R: rows of P a block
    row_blocks: int      # RB: blocks a head
    chunks: int          # chunks of BWD_CHUNK steps
    smem: int            # the main kernel's shared memory, bytes
    scratch: int         # floats of scratch the call needs
    heads: int = 0       # heads a tile block walks (chunked)

    def as_ints(self) -> list[int]:
        return [BWD_PATHS.index(self.path), self.lanes, self.rows,
                self.row_blocks, self.chunks, self.smem, self.scratch,
                self.heads]


def mamba2_bwd_plan(B: int, T: int, H: int, P: int, N: int,
                    dtype: torch.dtype) -> Mamba2BwdPlan:
    """The plan ``csrc/mamba_scan.cu::plan_mamba2_bwd`` makes for x, b, c
    in ``dtype``.

    Chunked (bfloat16, N <= 64, T > 8, the forward's rule): 64 rows of P a
    block, 64-step chunks, BWD_HEADS heads a tile block; scratch for the
    state entering and the gradient leaving every (batch row, chunk, head)
    in float32, the per-(b, t, head group, row block) partial sums of db
    and dc and the per-(b, t, head, row block) ones of da and ddt's direct
    terms.  CUDA cores (the others): the forward's CUDA-core lanes
    (NL = max(4, next_pow2(N / 4)), R = 4 * 128 / NL rows a block), the
    shared history of BWD_SUB + 1 states, two sub-chunks' staged inputs and
    the reverse steps' partial sums, and the scratch: a state slot a block
    and chunk (level 1) and sub-chunk (level 2), and per (b, t, head, row
    block) the partial sums of db, dc (N each), da and <g, x b^T>."""
    chunks = -(-T // BWD_CHUNK)
    if dtype == torch.bfloat16 and N <= 64 and T > DIRECT_T:
        RB = -(-P // 64)
        groups = -(-H // BWD_HEADS)
        scratch = (2 * B * chunks * H * P * N + 2 * B * T * groups * RB * N
                   + 2 * B * T * H * RB)
        return Mamba2BwdPlan("chunked", 0, 64, RB, chunks, CHUNKED_SMEM,
                             scratch, BWD_HEADS)
    NL = 4
    while NL * 4 < N:
        NL *= 2
    R = 4 * M2_THREADS // NL
    RB = -(-P // R)
    tile = 16 * M2_THREADS
    stage = 2 * BWD_SUB + 2 * BWD_SUB * R + 2 * BWD_SUB * 4 * NL
    partial = 12 * M2_THREADS + 4 * NL + 8   # a reverse step's partial sums
    smem = 4 * ((BWD_SUB + 1) * tile + 2 * stage + BWD_SUB * partial)
    scratch = (B * H * RB * (chunks + BWD_CHUNK // BWD_SUB) * tile
               + B * T * H * RB * (2 * N + 2))
    return Mamba2BwdPlan("cudacore", NL, R, RB, chunks, smem, scratch)


def kernel_mamba2_bwd_plan(B: int, T: int, H: int, P: int, N: int,
                           dtype: torch.dtype) -> Mamba2BwdPlan:
    """The plan the built kernel's host code makes (a card's library)."""
    out = (ctypes.c_longlong * 8)()
    _raise_on(_lib().mamba2_scan_bwd_plan(B, T, H, P, N, _DTYPES[dtype], out),
              "mamba2_scan_bwd_plan")
    v = list(map(int, out))
    return Mamba2BwdPlan(BWD_PATHS[v[0]], *v[1:])


def mamba2_scan_bwd(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor, A: torch.Tensor, h0: torch.Tensor,
                    dy: torch.Tensor, dh_last: torch.Tensor
                    ) -> tuple[torch.Tensor, ...]:
    """The gradient of ``mamba2_scan`` at (dt, x, b, c, A, h0) for output
    gradients dy (B, T, H, P) and dh_last (B, H, P, N): (ddt (B, T, H)
    float32, dx in x's dtype, db and dc (B, T, N) in b's, dA (H,) and dh0
    (B, H, P, N) float32), every output contiguous.  The operands as
    ``mamba2_scan`` takes them; dy and dh_last are made contiguous
    float32."""
    if dt.device.type == "cpu":
        return mamba2_scan_bwd_ref(dt, x, b, c, A, h0, dy, dh_last)
    if dt.device.type != "cuda":
        raise ValueError(f"unsupported device {dt.device}")
    _check_mamba2(dt, x, b, c, A, h0)
    B, T, H, P = x.shape
    N = b.shape[2]
    if tuple(dy.shape) != (B, T, H, P) or dh_last.shape != h0.shape:
        raise ValueError(f"want dy {(B, T, H, P)}, dh_last {tuple(h0.shape)};"
                         f" got {tuple(dy.shape)}, {tuple(dh_last.shape)}")
    if not (dy.device == dh_last.device == dt.device):
        raise ValueError("dy, dh_last and the operands on different devices")
    dy = dy.float().contiguous()
    dh_last = dh_last.float().contiguous()
    plan = mamba2_bwd_plan(B, T, H, P, N, x.dtype)
    f32, dev = torch.float32, dt.device
    ddt = torch.empty((B, T, H), dtype=f32, device=dev)
    dx = torch.empty((B, T, H, P), dtype=x.dtype, device=dev)
    db = torch.empty((B, T, N), dtype=b.dtype, device=dev)
    dc = torch.empty((B, T, N), dtype=c.dtype, device=dev)
    dA = torch.empty((H,), dtype=f32, device=dev)
    dh0 = torch.empty((B, H, P, N), dtype=f32, device=dev)
    scratch = torch.empty((plan.scratch,), dtype=f32, device=dev)
    args = _mamba2_args(dt, x, b, c, A, h0, ddt, dh0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().mamba2_scan_bwd(
            *args[:6], dy.data_ptr(), dh_last.data_ptr(), ddt.data_ptr(),
            dx.data_ptr(), db.data_ptr(), dc.data_ptr(), dA.data_ptr(),
            dh0.data_ptr(), scratch.data_ptr(), plan.scratch, *args[8:],
            stream)
    _raise_on(err, "mamba2_scan_bwd")
    mamba2_scan_bwd.launches += 1
    return ddt, dx, db, dc, dA, dh0


mamba2_scan_bwd.launches = 0


# --- the differentiable op ----------------------------------------------------

@torch.library.custom_op("repro_torch::mamba2_scan", mutates_args=())
def _mamba2_scan_op(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor, A: torch.Tensor, h0: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple(t.contiguous() for t in _mamba2_forward(dt, x, b, c, A, h0))


@torch.library.custom_op("repro_torch::mamba2_scan_bwd", mutates_args=())
def _mamba2_scan_bwd_op(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor, A: torch.Tensor, h0: torch.Tensor,
                        dy: torch.Tensor, dh_last: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor, torch.Tensor, torch.Tensor]:
    return tuple(t.contiguous()
                 for t in mamba2_scan_bwd(dt, x, b, c, A, h0, dy, dh_last))


def _scan_setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _mamba2_backward(ctx, dy, dh_last):
    dt, x, b, c, A, h0 = ctx.saved_tensors
    if dy is None:
        dy = dt.new_zeros(x.shape)
    if dh_last is None:
        dh_last = torch.zeros_like(h0, dtype=torch.float32)
    return tuple(torch.ops.repro_torch.mamba2_scan_bwd(
        dt, x, b, c, A, h0, dy, dh_last))


_mamba2_scan_op.register_autograd(_mamba2_backward,
                                  setup_context=_scan_setup_context)


@torch.library.custom_op("repro_torch::selective_scan", mutates_args=())
def _selective_scan_op(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, A: torch.Tensor, h0: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple(t.contiguous()
                 for t in _selective_forward(dt, x, b, c, A, h0))


@torch.library.custom_op("repro_torch::selective_scan_bwd", mutates_args=())
def _selective_scan_bwd_op(dt: torch.Tensor, x: torch.Tensor,
                           b: torch.Tensor, c: torch.Tensor, A: torch.Tensor,
                           h0: torch.Tensor, dy: torch.Tensor,
                           dh_last: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    return tuple(t.contiguous()
                 for t in selective_scan_bwd(dt, x, b, c, A, h0, dy, dh_last))


def _selective_backward(ctx, dy, dh_last):
    dt, x, b, c, A, h0 = ctx.saved_tensors
    if dy is None:
        dy = dt.new_zeros(dt.shape)
    if dh_last is None:
        dh_last = torch.zeros_like(h0, dtype=torch.float32)
    return tuple(torch.ops.repro_torch.selective_scan_bwd(
        dt, x, b, c, A, h0, dy, dh_last))


_selective_scan_op.register_autograd(_selective_backward,
                                     setup_context=_scan_setup_context)


# --- fake implementations and sharding rules ----------------------------------
# The outputs' shapes and dtypes of each op, and its DTensor rules: sharded
# on the batch (dA summed over it: Partial) or on the channels / heads
# (A and the state with them, b and c replicated; db and dc summed over
# them: Partial), or replicated.

def _f32(t, shape):
    return t.new_empty(shape, dtype=torch.float32)


@_selective_scan_op.register_fake
def _selective_scan_fake(dt, x, b, c, A, h0):
    return _f32(dt, dt.shape), _f32(h0, h0.shape)


@_mamba2_scan_op.register_fake
def _mamba2_scan_fake(dt, x, b, c, A, h0):
    return _f32(x, x.shape), _f32(h0, h0.shape)


def _bwd_fake(dt, x, b, c, A, h0, dy, dh_last):
    return (_f32(dt, dt.shape), torch.empty_like(x), torch.empty_like(b),
            torch.empty_like(c), _f32(A, A.shape), _f32(h0, h0.shape))


_selective_scan_bwd_op.register_fake(_bwd_fake)
_mamba2_scan_bwd_op.register_fake(_bwd_fake)


@register_sharding([torch.ops.repro_torch.selective_scan.default,
                    torch.ops.repro_torch.mamba2_scan.default])
def _scan_rules(dt, x, b, c, A, h0):
    R, S = Replicate(), Shard
    return [([R, R], [R] * 6),
            ([S(0), S(0)], [S(0)] * 4 + [R, S(0)]),
            ([S(2), S(1)], [S(2), S(2), R, R, S(0), S(1)])]


@register_sharding([torch.ops.repro_torch.selective_scan_bwd.default,
                    torch.ops.repro_torch.mamba2_scan_bwd.default])
def _scan_bwd_rules(dt, x, b, c, A, h0, dy, dh_last):
    R, S, P = Replicate(), Shard, Partial()
    return [([R] * 6, [R] * 8),
            ([S(0)] * 4 + [P, S(0)], [S(0)] * 4 + [R] + [S(0)] * 3),
            ([S(2), S(2), P, P, S(0), S(1)],
             [S(2), S(2), R, R, S(0), S(1), S(2), S(1)])]
