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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
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

@torch.library.custom_op("repro_torch::flash_attn", mutates_args=())
def _flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, window: int, softcap: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_attention_lse(q, k, v, causal=causal, window=window,
                               softcap=softcap)


@torch.library.custom_op("repro_torch::flash_attn_bwd", mutates_args=())
def _flash_attn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                    causal: bool, window: int, softcap: float
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                               window=window, softcap=softcap)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, window, softcap = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.attrs = (causal, window, softcap)


def _backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = torch.ops.repro_torch.flash_attn_bwd(
        q, k, v, o, lse, do, *ctx.attrs)
    return dq, dk, dv, None, None, None


_flash_attn.register_autograd(_backward, setup_context=_setup_context)


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
