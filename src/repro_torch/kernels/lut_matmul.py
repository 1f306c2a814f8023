"""4-bit codebook (LUT) matmul: the wrapper around the Hopper kernel.

Replaces ``repro/kernels/lut_matmul.py::lut_matmul`` (Pallas TPU).  The
kernel is CUDA C++ in ``csrc/lut_matmul.cu``, built by ``_build`` and called
through its C interface: ``Y = X @ dequant(codes, lut)`` with the weight
tile rebuilt in shared memory and the products on the tensor cores as
3xTF32 (float32 accuracy from three TF32 products).  A tensor on the CPU goes to the plain ``ref.lut_matmul_ref``; a
CUDA tensor goes to the kernel or the call raises.  ``lut_matmul.launches``
counts kernel launches.  ``quantize_weights`` is the reference's plain
quantizer, which makes the codes and codebooks.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import lut_matmul_ref

GROUP = 64          # K-rows per codebook group
LEVELS = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("lut_matmul").lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lut_matmul_fwd.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.lut_matmul_fwd.restype = i
    lib.lm_error_string.argtypes = [i]
    lib.lm_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, codes, lut):
    if x.dim() != 2 or codes.dim() != 2 or x.shape[1] != codes.shape[0]:
        raise ValueError(f"want x (M,K), codes (K,N); got {tuple(x.shape)}, "
                         f"{tuple(codes.shape)}")
    M, K = x.shape
    N = codes.shape[1]
    if min(M, K, N) == 0 or K % GROUP:
        raise ValueError(f"K {K} must be a positive multiple of {GROUP}")
    if tuple(lut.shape) != (K // GROUP, N, LEVELS):
        raise ValueError(f"lut {tuple(lut.shape)} != "
                         f"{(K // GROUP, N, LEVELS)}")
    if not (x.device == codes.device == lut.device):
        raise ValueError("x, codes, lut on different devices")
    if x.dtype not in _DTYPES or codes.dtype != torch.uint8 \
            or lut.dtype != torch.float32:
        raise TypeError(f"x {x.dtype}, codes {codes.dtype}, lut {lut.dtype}: "
                        "the kernel takes float32/bfloat16 x, uint8 codes and "
                        "float32 codebooks")
    for name, t in (("x", x), ("codes", codes), ("lut", lut)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16 or lut.data_ptr() % 16:
        raise ValueError("x is read through a TMA tensor map and lut as "
                         "16-byte vectors: both need 16-byte aligned "
                         "pointers")


def lut_matmul(x: torch.Tensor, codes: torch.Tensor, lut: torch.Tensor
               ) -> torch.Tensor:
    """Y[M, N] = X[M, K] @ dequant(codes, lut)[K, N], float32, without
    materializing the weight matrix.  Any M and N; K a multiple of GROUP."""
    if x.device.type == "cpu":
        return lut_matmul_ref(x, codes, lut)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, codes, lut)
    M, K = x.shape
    N = codes.shape[1]
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.lut_matmul_fwd(x.data_ptr(), codes.data_ptr(),
                                 lut.data_ptr(), y.data_ptr(),
                                 _DTYPES[x.dtype], M, N, K, stream)
    if err != 0:
        raise RuntimeError(f"lut_matmul launch failed: cudaError {err} "
                           f"({lib.lm_error_string(err).decode()})")
    lut_matmul.launches += 1
    return y


lut_matmul.launches = 0


def quantize_weights(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """4-bit grouped quantizer: per-(group, column) asymmetric 16-level
    uniform codebook.  w (K, N) -> (codes (K, N) uint8,
    levels (K // GROUP, N, 16) float32)."""
    K, N = w.shape
    if K % GROUP:
        raise ValueError(f"K {K} must be a multiple of {GROUP}")
    wg = w.reshape(K // GROUP, GROUP, N).float()
    lo = wg.amin(dim=1)                                      # (g, N)
    hi = wg.amax(dim=1)
    scale = torch.where(hi > lo, (hi - lo) / 15.0, torch.ones_like(lo))
    codes = torch.clamp(torch.round((wg - lo[:, None]) / scale[:, None]),
                        0, 15).to(torch.uint8)
    levels = lo[..., None] + scale[..., None] * torch.arange(
        float(LEVELS), device=w.device)                      # (g, N, 16)
    return codes.reshape(K, N), levels
