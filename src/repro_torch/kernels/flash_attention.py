"""Flash attention: the wrappers around the Hopper kernels, forward and
backward.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (Pallas TPU)
and, for training, ``jax.grad`` of the reference's attention scan
(``repro/models/layers.py::attention``, which recomputes its score blocks in
the VJP).  The kernels are CUDA C++ in ``csrc/flash_attention.cu`` (forward,
optionally writing the row log-sum-exp) and ``csrc/flash_attention_bwd.cu``
(dQ, dK, dV from q, k, v, o, the LSE and dO), built by ``_build`` and called
through their C interfaces.  A tensor on the CPU goes to the plain versions
in ``ref``; a CUDA tensor goes to the kernels or the call raises.

Under grad mode with an input that requires grad, ``flash_attention_gqa``
runs the ``repro_torch::flash_attn`` custom op, whose forward writes the LSE
and saves q, k, v, o and the LSE, and whose autograd formula is the
``repro_torch::flash_attn_bwd`` op.  Both are dispatcher ops, so selective
activation checkpointing sees them.  Otherwise (serving) the forward writes
no LSE and saves nothing.  ``flash_attention_gqa.launches`` and
``flash_attention_bwd.launches`` count kernel launches.

A DTensor or fake input goes to the op as well (``_symbolic``): both ops
have fake implementations, and sharding rules that take the batch, or the
heads when both q's and k's head counts divide the mesh dimension, and
replicate otherwise (``_gqa_layout`` puts q, k and v there first, since a
kv head serves the ``H // K`` query heads beside it).
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, _symbolic
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_gqa_ref,
                                     flash_attention_ref)

HEAD_DIMS = (64, 80, 128, 256)
BWD_HEAD_DIMS = (64, 80, 128, 256)  # the backward kernel's
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention").lib
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fa_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                           ll, ll, ll, ll, ll, ll, ll, ll,
                           i, i, ctypes.c_float, ctypes.c_float,
                           p, ll, ll, p]
    lib.fa_fwd.restype = i
    lib.fa_error_string.argtypes = [i]
    lib.fa_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd").lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fa_bwd.argtypes = [p] * 10 + [i] * 9 + [ctypes.c_float] * 2 + [p]
    lib.fa_bwd.restype = i
    lib.fa_bwd_error_string.argtypes = [i]
    lib.fa_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, window, softcap):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,Tq,H,D), k/v (B,Tk,K,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Tq, H, D = q.shape
    Bk, Tk, K, Dk = k.shape
    if Bk != B or Dk != D or K == 0 or H % K:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "form a GQA pair")
    if Tq == 0 or Tk == 0:
        raise ValueError("empty sequence")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the kernel "
                        "takes float32 or bfloat16, all alike")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D}: the kernel takes {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_tma(name, t, D)
    if window < 0 or softcap < 0:
        raise ValueError("window and softcap must be >= 0")


def _check_tma(name: str, t: torch.Tensor, D: int) -> None:
    """(B, T, heads, D) contiguous over (heads, head_dim); in bf16 also what
    a TMA tensor map needs."""
    if t.stride(3) != 1 or t.stride(2) != D:
        raise ValueError(f"{name} must be contiguous over (heads, "
                         f"head_dim); strides {t.stride()}")
    if t.dtype == torch.bfloat16 and (
            t.data_ptr() % 16 or t.stride(0) % 8 or t.stride(1) % 8):
        raise ValueError(f"{name}: bf16 tensors are read through TMA "
                         "tensor maps, which need a 16-byte aligned "
                         "pointer and batch/time strides that are "
                         f"multiples of 8, got strides {t.stride()}")


def _forward(q, k, v, causal: bool, window: int, softcap: float,
             want_lse: bool):
    """One launch of the forward kernel -> (o, lse or None)."""
    _check(q, k, v, window, softcap)
    B, Tq, H, D = q.shape
    Tk, K = k.shape[1], k.shape[2]
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fa_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), _DTYPES[q.dtype], B, H, K, Tq, Tk, D,
                         q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                         v.stride(0), v.stride(1), o.stride(0), o.stride(1),
                         int(causal), int(window), float(softcap),
                         float(D ** -0.5),
                         lse.data_ptr() if want_lse else None,
                         H * Tq, Tq, stream)
    if err != 0:
        raise RuntimeError(f"flash attention launch failed: cudaError {err} "
                           f"({lib.fa_error_string(err).decode()})")
    flash_attention_gqa.launches += 1
    return o, lse


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Tq, H, D); k, v: (B, Tk, K, D) -> (B, Tq, H, D), q's dtype.

    Head h attends to kv head h // (H // K).  Any Tq, Tk (ragged tails are
    masked in the kernel).  Batch and time strides are free, so a slice of a
    longer KV cache needs no copy.  Differentiable: under grad mode with an
    input that requires grad this is the ``repro_torch::flash_attn`` op.
    """
    if _symbolic.is_dtensor(q):
        grouped = _head_groups(q, k, v, causal, window, softcap)
        if grouped is not None:
            return grouped
    if _symbolic.symbolic(q, k, v) or torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        q, k, v = _gqa_layout(q, k, v)
        return torch.ops.repro_torch.flash_attn(
            q, k, v, bool(causal), int(window), float(softcap))[0]
    if q.device.type == "cpu":
        return flash_attention_gqa_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _forward(q, k, v, causal, window, softcap, want_lse=False)[0]


flash_attention_gqa.launches = 0


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward with its row log-sum-exp: (o (B, Tq, H, D), lse (B, H,
    Tq) float32, natural-log units of the scaled, soft-capped scores)."""
    if q.device.type == "cpu":
        return flash_attention_gqa_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap, return_lse=True)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _forward(q, k, v, causal, window, softcap, want_lse=True)


def _check_bwd(q, k, o, lse, do, causal, window=0):
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if D not in BWD_HEAD_DIMS:
        raise ValueError(f"head_dim {D}: the backward kernel takes "
                         f"{BWD_HEAD_DIMS}")
    if causal and Tk != Tq:
        raise ValueError("the backward kernel takes causal attention with "
                         "Tq == Tk (self-attention) or non-causal attention "
                         f"with any Tq, Tk; got causal, Tq={Tq}, Tk={Tk}")
    if not causal and window:
        raise ValueError("the backward kernel takes a window only under "
                         f"causal attention; got window={window}")
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype} and do "
                         f"{tuple(do.shape)} {do.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if lse.shape != (B, H, Tq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({B}, {H}, {Tq}) float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if not all(t.device == q.device for t in (o, lse, do)):
        raise ValueError("backward operands on different devices")
    for name, t in (("o", o), ("do", do)):
        _check_tma(name, t, D)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, on a 16-byte boundary (the bf16 kernels read q, k, v and
    dO through TMA tensor maps)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq (B, Tq, H, D), dk, dv (B, Tk, K, D) in the inputs' dtype, from
    the forward's q, k, v, o, lse and the output gradient do.  Causal with
    Tq == Tk (any T, a window), or non-causal with any Tq, Tk >= 1 (no
    window; cross-attention); soft-cap, D in ``BWD_HEAD_DIMS``, float32 or
    bfloat16; anything else raises.  Inputs are made contiguous and
    aligned."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    q, k, v, o, lse, do = (_aligned(t) for t in (q, k, v, o, lse, do))
    _check(q, k, v, window, softcap)
    _check_bwd(q, k, o, lse, do, causal, window)
    B, Tq, H, D = q.shape
    Tk, K = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fa_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), lse.data_ptr(), do.data_ptr(),
                         dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                         delta.data_ptr(), _DTYPES[q.dtype], B, H, K, Tq, Tk,
                         D, int(causal), int(window), float(softcap),
                         float(D ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"flash attention backward launch failed: "
                           f"cudaError {err} "
                           f"({lib.fa_bwd_error_string(err).decode()})")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


# --- the differentiable op ---------------------------------------------------

def _head_groups(q, k, v, causal, window, softcap):
    """Attention with q's heads sharded over a mesh dimension of size n
    that divides H but not K, where a rank's H / n query heads share
    whole kv heads (G = H // K a multiple of H / n, or H / n a multiple
    of G): each rank runs the kernel on its query heads and the slice of
    the (gathered) kv heads they read, and k's and v's gradients are
    partial sums over the ranks.  None where that does not hold (the op's
    sharding rule then takes the call)."""
    from torch.distributed.tensor import DTensor, Partial

    mesh = q.device_mesh
    dims = [i for i, p in enumerate(q.placements)
            if isinstance(p, Shard) and p.dim == 2]
    H, K = q.shape[2], k.shape[2]
    if len(dims) != 1:
        return None
    i = dims[0]
    n, G = mesh.size(i), H // K
    Hn = H // n
    if H % n or K % n == 0 or (Hn % G and G % Hn):
        return None
    kvn = max(Hn // G, 1)
    kv0 = mesh.get_coordinate()[i] * Hn // G
    batch = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
             for p in q.placements]
    want_q = [Shard(2) if j == i else p for j, p in enumerate(batch)]
    q, k, v = (_symbolic.to_layout(t, mesh, pl) for t, pl in
               ((q, want_q), (k, batch), (v, batch)))
    grad_kv = [Partial() if j == i else p for j, p in enumerate(batch)]
    o = flash_attention_gqa(
        q.to_local(), *(t.to_local(grad_placements=grad_kv)[
            :, :, kv0:kv0 + kvn] for t in (k, v)),
        causal=causal, window=window, softcap=softcap)
    return DTensor.from_local(o, mesh, want_q, run_check=False,
                              shape=q.shape, stride=q.stride())


def _gqa_layout(q, k, v):
    """DTensor q, k, v on placements the op's rule takes: on each mesh
    dimension the batch stays sharded if q's is; the heads stay sharded if
    q's are and both H and K divide the dimension (so a rank's query heads
    find their kv heads among its own); anything else is replicated.
    Plain tensors pass through."""
    if not _symbolic.is_dtensor(q):
        return q, k, v
    mesh = q.device_mesh
    H, K = q.shape[2], k.shape[2]
    want = []
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        if isinstance(p, Shard) and p.dim == 0:
            want.append(Shard(0))
        elif (isinstance(p, Shard) and p.dim == 2 and H % n == 0
              and K % n == 0):
            want.append(Shard(2))
        else:
            want.append(Replicate())

    return tuple(_symbolic.to_layout(t, mesh, want) for t in (q, k, v))

@torch.library.custom_op("repro_torch::flash_attn", mutates_args=())
def _flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, window: int, softcap: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    # contiguous, as the fake implementation says (the plain version's o
    # is a permuted view)
    return tuple(t.contiguous() for t in flash_attention_lse(
        q, k, v, causal=causal, window=window, softcap=softcap))


@torch.library.custom_op("repro_torch::flash_attn_bwd", mutates_args=())
def _flash_attn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                    causal: bool, window: int, softcap: float
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return tuple(t.contiguous() for t in flash_attention_bwd(
        q, k, v, o, lse, do, causal=causal, window=window, softcap=softcap))


def _setup_context(ctx, inputs, output):
    q, k, v, causal, window, softcap = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.attrs = (causal, window, softcap)


def _backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    if _symbolic.is_dtensor(do) and do.placements != o.placements:
        do = do.redistribute(o.device_mesh, o.placements)
    dq, dk, dv = torch.ops.repro_torch.flash_attn_bwd(
        q, k, v, o, lse, do, *ctx.attrs)
    return dq, dk, dv, None, None, None


_flash_attn.register_autograd(_backward, setup_context=_setup_context)


@_flash_attn.register_fake
def _flash_attn_fake(q, k, v, causal, window, softcap):
    B, Tq, H, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((B, H, Tq), dtype=torch.float32))


@_flash_attn_bwd.register_fake
def _flash_attn_bwd_fake(q, k, v, o, lse, do, causal, window, softcap):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@register_sharding(torch.ops.repro_torch.flash_attn.default)
def _flash_rules(q, k, v, causal, window, softcap):
    R, S = Replicate(), Shard
    flags = [None] * 3
    return [([R, R], [R, R, R, *flags]),
            ([S(0), S(0)], [S(0), S(0), S(0), *flags]),
            ([S(2), S(1)], [S(2), S(2), S(2), *flags])]


@register_sharding(torch.ops.repro_torch.flash_attn_bwd.default)
def _flash_bwd_rules(q, k, v, o, lse, do, causal, window, softcap):
    R, S = Replicate(), Shard
    flags = [None] * 3
    return [([R] * 3, [R] * 6 + flags),
            ([S(0)] * 3, [S(0)] * 6 + flags),
            ([S(2)] * 3, [S(2), S(2), S(2), S(2), S(1), S(2), *flags])]


@register_flop_formula(torch.ops.repro_torch.flash_attn)
def _attn_flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    """Two products a head, Q K^T and P V: 4 B H Tq Tk D (the full
    rectangle, causal or not, as ``FlopCounterMode`` counts SDPA)."""
    B, Tq, H, D = q_shape
    return 4 * B * H * Tq * k_shape[1] * D


@register_flop_formula(torch.ops.repro_torch.flash_attn_bwd)
def _attn_bwd_flops(q_shape, k_shape, *args, out_shape=None,
                    **kwargs) -> int:
    """Five products: Q K^T again, dO V^T, P^T dO, dS K and dS^T Q."""
    B, Tq, H, D = q_shape
    return 10 * B * H * Tq * k_shape[1] * D


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (BH, Tq, D); k, v: (BH, Tk, D) — the reference kernel's layout."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    return flash_attention_gqa(q[:, :, None], k[:, :, None], v[:, :, None],
                               causal=causal, window=window,
                               softcap=softcap)[:, :, 0]
