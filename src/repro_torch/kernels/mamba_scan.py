"""Selective scan: the wrappers around the Hopper kernel.

Replaces ``repro/kernels/mamba_scan.py::mamba_scan`` (Pallas TPU).  The
kernel is CUDA C++ in ``csrc/mamba_scan.cu``, built by ``_build`` and called
through its C interface, with two entry points over one recurrence core:

* ``mamba_scan(decay, u, c)``: the TPU kernel's contract, any ``T``;
* ``selective_scan(dt, x, b, c, A, h0)``: the fused Mamba-1 form that
  ``models/ssm.py::mamba1_block`` calls, which builds decay and u in
  registers and never stores the (B, T, D, N) products.

A tensor on the CPU goes to the plain versions in ``ref``; a CUDA tensor
goes to the kernel or the call raises.  ``mamba_scan.launches`` and
``selective_scan.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mamba_scan_ref, selective_scan_ref

MAX_STATE = 128                 # N: 32 lanes of 4 states each
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mamba_scan").lib
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mamba_scan_fwd.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.mamba_scan_fwd.restype = i
    lib.selective_scan_fwd.argtypes = [p] * 8 + [i] * 5 + [ll] * 8 + [p]
    lib.selective_scan_fwd.restype = i
    lib.ms_error_string.argtypes = [i]
    lib.ms_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err} "
                           f"({_lib().ms_error_string(err).decode()})")


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


def selective_scan(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, A: torch.Tensor, h0: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1 selective scan from state ``h0``.

    dt (B, T, D) float32; x (B, T, D), b and c (B, T, N) in float32 or
    bfloat16 (batch and time strides free, so slices of one projection need
    no copy); A (D, N) and h0 (B, D, N) float32.  Returns y (B, T, D) and
    the last state (B, D, N), both float32: ``decay_t = exp(dt_t * A)``,
    ``u_t = (dt_t * x_t) * b_t``, ``h_t = decay_t * h_{t-1} + u_t``,
    ``y_t = sum_n h_t * c_t``.
    """
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
            dt.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(),
            A.data_ptr(), h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
            _DTYPES[x.dtype], B, T, D, N, dt.stride(0), dt.stride(1),
            x.stride(0), x.stride(1), b.stride(0), b.stride(1), c.stride(0),
            c.stride(1), stream)
    _raise_on(err, "selective_scan")
    selective_scan.launches += 1
    return y, h_last


selective_scan.launches = 0
