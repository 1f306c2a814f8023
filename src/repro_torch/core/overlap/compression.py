"""Gradient compression for slow (cross-pod) links, with error feedback
(PyTorch port of ``repro/core/overlap/compression.py``).

The cross-pod data-parallel all-reduce rides the slowest links; an int8
block-quantized all-reduce cuts its bytes 4x while error feedback keeps
the optimizer unbiased in the long run:

    e      <- residual carried from last step
    g_hat  <- quantize(g + e)
    e'     <- (g + e) - dequantize(g_hat)
    g_out  <- sum over ranks of dequantize(g_hat) / n

Used by ``train_step`` for the 'pod' mesh dimension when
``TrainSettings.compress_pod_grads`` is set.  The 8-bit AdamW state stores
its moments in the same int8 format.  ``torch.round`` and ``jnp.round``
both round half to even, so the int8 codes equal the reference's byte for
byte.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import tree

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


def psum_compressed(grad: torch.Tensor, err: torch.Tensor, group
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 all-reduce of one gradient leaf over ``group``.

    Returns (mean gradient, new error residual), both in ``grad``'s dtype.
    Only the int8 codes (1 byte an element) and the float32 block scales
    (4 bytes a block) ride the link; every rank sums the gathered codes in
    the reference's order, ``einsum("rnb,rn->nb")`` in float32, then
    divides by n.
    """
    g = grad.float() + err.float()
    codes, scale = quantize(g)
    new_err = g - dequantize(codes, scale, tuple(grad.shape), torch.float32)
    n = dist.get_world_size(group)
    codes_all = [torch.empty_like(codes) for _ in range(n)]
    scales_all = [torch.empty_like(scale) for _ in range(n)]
    dist.all_gather(codes_all, codes, group=group)          # (n, N, B) int8
    dist.all_gather(scales_all, scale, group=group)         # (n, N) f32
    summed = torch.einsum("rnb,rn->nb", torch.stack(codes_all).float(),
                          torch.stack(scales_all))
    flat = (summed / n).reshape(-1)
    mean = flat[:grad.numel()].reshape(grad.shape).to(grad.dtype)
    return mean, new_err.to(grad.dtype)


def tree_psum_compressed(grads, errs, group):
    """``psum_compressed`` over every leaf -> (mean grads, new errors)."""
    out = [psum_compressed(g, e, group)
           for g, e in zip(tree.leaves(grads), tree.leaves(errs))]
    return (tree.unflatten(grads, [o[0] for o in out]),
            tree.unflatten(grads, [o[1] for o in out]))


def init_error_state(params):
    return tree.map_leaves(
        lambda p: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device),
        params)
