"""Model-layer-friendly wrappers for the port's kernels.

Counterpart of ``repro/kernels/ops.py``.  The reference folds (batch,
kv-head, group) into the kernel's leading dim by broadcasting K/V G times;
the Hopper kernel indexes kv head ``h // G`` instead, which gives the same
result without the copy.  ``selective_scan`` and ``mamba2_scan`` are the
fused Mamba-1 and Mamba-2 forms of the ``mamba_scan`` kernel, which
``models/ssm.py`` calls.
"""

from __future__ import annotations

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lut_matmul as lm
from repro_torch.kernels import mamba_scan as ms


def lut_matmul(x, codes, lut):
    return lm.lut_matmul(x, codes, lut)


def quantize_weights(w):
    return lm.quantize_weights(w)


def gqa_flash_attention(q, k, v, **kw):
    """q: (B, T, H, Dh); k/v: (B, T, K, Dh) -> (B, T, H, Dh)."""
    return fa.flash_attention_gqa(q, k, v, **kw)


def mamba_scan(decay, u, c):
    return ms.mamba_scan(decay, u, c)


def selective_scan(dt, x, b, c, A, h0):
    """dt, x: (B, T, di); b, c: (B, T, n); A: (di, n); h0: (B, di, n) ->
    (y (B, T, di), h_last (B, di, n)), float32."""
    return ms.selective_scan(dt, x, b, c, A, h0)


def mamba2_scan(dt, x, b, c, A, h0):
    """dt: (B, T, H); x: (B, T, H, P); b, c: (B, T, n); A: (H,);
    h0: (B, H, P, n) -> (y (B, T, H, P), h_last (B, H, P, n)), float32."""
    return ms.mamba2_scan(dt, x, b, c, A, h0)
