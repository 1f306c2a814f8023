"""int8 block quantization (PyTorch port of the quantizer in
``repro/core/overlap/compression.py``).

The 8-bit AdamW state stores its moments in this format.  Only the
quantizer is ported here: the error-feedback compressed all-reduce
(``psum_compressed``) and its error state belong to the distributed slice.
``torch.round`` and ``jnp.round`` both round half to even, so the int8
codes equal the reference's byte for byte.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BLOCK = 256


def _blockify(x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, ...], int]:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK), tuple(x.shape), pad


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 block quantization -> (codes int8 (N, BLOCK), scales f32 (N,))."""
    blocks, _, _ = _blockify(x.float())
    scale = blocks.abs().amax(dim=1) / 127.0
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    codes = torch.clamp(torch.round(blocks / safe[:, None]), -127, 127
                        ).to(torch.int8)
    return codes, scale


def dequantize(codes: torch.Tensor, scale: torch.Tensor,
               shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    flat = (codes.float() * scale[:, None]).reshape(-1)
    size = math.prod(shape)
    return flat[:size].reshape(shape).to(dtype)
