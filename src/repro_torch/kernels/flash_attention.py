"""Flash attention: the wrapper around the Hopper kernel.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (Pallas TPU).
The kernel is CUDA C++ in ``csrc/flash_attention.cu``, built by ``_build``
and called through its C interface.  A tensor on the CPU goes to the plain
versions in ``ref``; a CUDA tensor goes to the kernel or the call raises.
``flash_attention_gqa.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_gqa_ref, flash_attention_ref

HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention").lib
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fa_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                           ll, ll, ll, ll, ll, ll, ll, ll,
                           i, i, ctypes.c_float, ctypes.c_float, p]
    lib.fa_fwd.restype = i
    lib.fa_error_string.argtypes = [i]
    lib.fa_error_string.restype = ctypes.c_char_p
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
        if t.stride(3) != 1 or t.stride(2) != D:
            raise ValueError(f"{name} must be contiguous over (heads, "
                             f"head_dim); strides {t.stride()}")
        if t.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or t.stride(0) % 8 or t.stride(1) % 8):
            raise ValueError(f"{name}: bf16 tensors are read through TMA "
                             "tensor maps, which need a 16-byte aligned "
                             "pointer and batch/time strides that are "
                             f"multiples of 8, got strides {t.stride()}")
    if window < 0 or softcap < 0:
        raise ValueError("window and softcap must be >= 0")


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Tq, H, D); k, v: (B, Tk, K, D) -> (B, Tq, H, D), q's dtype.

    Head h attends to kv head h // (H // K).  Any Tq, Tk (ragged tails are
    masked in the kernel).  Batch and time strides are free, so a slice of a
    longer KV cache needs no copy.
    """
    if q.device.type == "cpu":
        return flash_attention_gqa_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v, window, softcap)
    B, Tq, H, D = q.shape
    Tk, K = k.shape[1], k.shape[2]
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fa_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), _DTYPES[q.dtype], B, H, K, Tq, Tk, D,
                         q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                         v.stride(0), v.stride(1), o.stride(0), o.stride(1),
                         int(causal), int(window), float(softcap),
                         float(D ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"flash attention launch failed: cudaError {err} "
                           f"({lib.fa_error_string(err).decode()})")
    flash_attention_gqa.launches += 1
    return o


flash_attention_gqa.launches = 0


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
