"""Plain float32 reference of the Mamba-2 hybrid family (zamba2-2.7b):
token embedding, then groups of ``attn_every`` Mamba-2 layers (x +=
mamba2(rms_norm(x))), each group followed by shared block ``g %
n_shared_attn_blocks`` (x += attention(rms_norm(x)), x += SwiGLU(
rms_norm(x)), rope, causal), a final rms_norm, the unembedding.  Imports
torch and the benchmark's plain pieces only.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from yardstick import plain


def _mamba_layer(x, blk, m, fp8):
    return plain.low(x + plain.mamba2_block(
        blk["mixer"], plain.rms_norm(x, blk["ln"], m["norm_eps"]), m, fp8),
        fp8)


def _shared_block(x, sa, m, fp8):
    x = plain.low(x + plain.attention_block(
        sa["attn"], plain.rms_norm(x, sa["ln"], m["norm_eps"]), m, fp8), fp8)
    return plain.low(x + plain.mlp_block(
        sa["mlp"], plain.rms_norm(x, sa["ln2"], m["norm_eps"]), m, fp8), fp8)


def logits(P: dict, tokens: torch.Tensor, m: dict, fp8: bool = False,
           last_only: bool = False, remat: bool = False) -> torch.Tensor:
    """(B, T) tokens -> float32 logits (B, T, V), or (B, 1, V) of the last
    position.  ``P`` maps leaf paths to float32 tensors; ``remat``
    recomputes each layer and shared block in the backward."""
    def run(fn, *args):
        if remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    x = plain.low(P["embed"][tokens], fp8)
    blocks = plain.layer_slices(P, "blocks")
    shared = plain.layer_slices(P, "shared_attn")
    k = m["attn_every"]
    for g in range(m["n_layers"] // k):
        for blk in blocks[g * k:(g + 1) * k]:
            x = run(_mamba_layer, x, blk, m, fp8)
        x = run(_shared_block, x, shared[g % len(shared)], m, fp8)
    x = plain.rms_norm(x, P["final_norm"], m["norm_eps"])
    if last_only:
        x = x[:, -1:]
    w = P["embed"].T if m["tie_embeddings"] else P["unembed"]
    return plain.mm(x, w, fp8)
