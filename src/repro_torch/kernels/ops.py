"""Model-layer-friendly wrappers for the port's kernels.

Counterpart of ``repro/kernels/ops.py``.  The reference folds (batch,
kv-head, group) into the kernel's leading dim by broadcasting K/V G times;
the Hopper kernel indexes kv head ``h // G`` instead, which gives the same
result without the copy.
"""

from __future__ import annotations

from repro_torch.kernels import flash_attention as fa


def gqa_flash_attention(q, k, v, **kw):
    """q: (B, T, H, Dh); k/v: (B, T, K, Dh) -> (B, T, H, Dh)."""
    return fa.flash_attention_gqa(q, k, v, **kw)
