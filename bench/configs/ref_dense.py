"""Plain float32 reference of the dense decoder family (granite-3-2b):
token embedding (scaled by sqrt(d) when the unembedding is tied), then per
layer x += attention(rms_norm(x)) and x += SwiGLU(rms_norm(x)) with rope
and causal GQA attention, a final rms_norm, the unembedding.  Imports
torch and the benchmark's plain pieces only.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from yardstick import plain


def _layer(x, blk, m, fp8):
    eps = m["norm_eps"]
    x = plain.low(x + plain.attention_block(
        blk["attn"], plain.rms_norm(x, blk["ln1"], eps), m, fp8), fp8)
    return plain.low(x + plain.mlp_block(
        blk["mlp"], plain.rms_norm(x, blk["ln2"], eps), m, fp8), fp8)


def logits(P: dict, tokens: torch.Tensor, m: dict, fp8: bool = False,
           last_only: bool = False, remat: bool = False) -> torch.Tensor:
    """(B, T) tokens -> float32 logits (B, T, V), or (B, 1, V) of the last
    position.  ``P`` maps leaf paths to float32 tensors; ``remat``
    recomputes each layer in the backward, so that a training step fits."""
    x = P["embed"][tokens]
    if m["tie_embeddings"]:
        x = x * math.sqrt(m["d_model"])
    x = plain.low(x, fp8)
    for blk in plain.layer_slices(P, "blocks"):
        if remat:
            x = checkpoint(_layer, x, blk, m, fp8, use_reentrant=False)
        else:
            x = _layer(x, blk, m, fp8)
    x = plain.rms_norm(x, P["final_norm"], m["norm_eps"])
    if last_only:
        x = x[:, -1:]
    w = P["embed"].T if m["tie_embeddings"] else P["unembed"]
    return plain.mm(x, w, fp8)
