"""The weights a run hands to the program and to the reference, made by the
benchmark from ``--seed`` on the run's device: one generator call a leaf,
each leaf from its own seed, so that one leaf can be made again alone.

The tree is the program's parameter layout (nested dicts, the layer stack
on a leading dimension), written out here leaf by leaf from the
configuration's sizes: the layout is the interface the benchmark feeds,
and the values are the benchmark's own.  The scales are the usual ones: a
projection N(0, 1/fan_in), the embedding N(0, 0.02), the norms' (zero
centred) weights N(0, 0.1); a Mamba-2 layer's A = -U(1, 16) and its
dt bias the inverse softplus of a log-uniform dt in [1e-3, 1e-1], as
Mamba-2 initialises them, so that the scan carries its state over many
steps.
"""

from __future__ import annotations

import dataclasses
import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class Leaf:
    path: str                       # "blocks.attn.wq"
    shape: tuple[int, ...]
    dtype: torch.dtype
    init: tuple                     # ("normal", std) | ("ones",) | ...


def leaves(m: dict) -> list[Leaf]:
    """Every parameter leaf of the configuration file's ``model``, in a
    fixed order (its index seeds it)."""
    dt = DTYPES[m["dtype"]]
    f32 = torch.float32
    d, V, L = m["d_model"], m["vocab_size"], m["n_layers"]
    H, K, Dh, F = m["n_heads"], m["n_kv_heads"], m["head_dim"], m["d_ff"]
    norm = ("normal", 0.1)

    def attn(prefix, n):
        return [Leaf(f"{prefix}.attn.wq", (n, d, H, Dh), dt,
                     ("normal", d ** -0.5)),
                Leaf(f"{prefix}.attn.wk", (n, d, K, Dh), dt,
                     ("normal", d ** -0.5)),
                Leaf(f"{prefix}.attn.wv", (n, d, K, Dh), dt,
                     ("normal", d ** -0.5)),
                Leaf(f"{prefix}.attn.wo", (n, H, Dh, d), dt,
                     ("normal", (H * Dh) ** -0.5))]

    def mlp(prefix, n):
        return [Leaf(f"{prefix}.mlp.wi_gate", (n, d, F), dt,
                     ("normal", d ** -0.5)),
                Leaf(f"{prefix}.mlp.wi_up", (n, d, F), dt,
                     ("normal", d ** -0.5)),
                Leaf(f"{prefix}.mlp.wo", (n, F, d), dt, ("normal", F ** -0.5))]

    out = [Leaf("embed", (V, d), dt, ("normal", 0.02)),
           Leaf("final_norm", (d,), dt, norm)]
    if not m["tie_embeddings"]:
        out.append(Leaf("unembed", (d, V), dt, ("normal", d ** -0.5)))
    if m["family"] == "dense":
        out += [Leaf("blocks.ln1", (L, d), dt, norm), *attn("blocks", L),
                Leaf("blocks.ln2", (L, d), dt, norm), *mlp("blocks", L)]
    elif m["family"] == "hybrid":
        di = m["ssm_expand"] * d
        n, Hs, conv = m["ssm_state"], di // m["ssm_head_dim"], m["ssm_conv"]
        mx = "blocks.mixer"
        S = m["n_shared_attn_blocks"]
        fan_d, fan_di = ("normal", d ** -0.5), ("normal", di ** -0.5)
        out += [Leaf("blocks.ln", (L, d), dt, norm),
                Leaf(f"{mx}.in_proj", (L, d, 2 * di), dt, fan_d),
                Leaf(f"{mx}.conv_w", (L, conv, di), dt,
                     ("normal", conv ** -0.5)),
                Leaf(f"{mx}.conv_b", (L, di), dt, norm),
                Leaf(f"{mx}.out_proj", (L, di, d), dt, fan_di),
                Leaf(f"{mx}.bc_proj", (L, d, 2 * n), dt, fan_d),
                Leaf(f"{mx}.dt_bias", (L, Hs), f32, ("dt_bias", 1e-3, 1e-1)),
                Leaf(f"{mx}.A_log", (L, Hs), f32, ("log_uniform", 1.0, 16.0)),
                Leaf(f"{mx}.D", (L, Hs), f32, ("ones",)),
                Leaf(f"{mx}.dt_proj_h", (L, d, Hs), f32, fan_d),
                Leaf(f"{mx}.norm_w", (L, di), dt, norm),
                Leaf("shared_attn.ln", (S, d), dt, norm),
                *attn("shared_attn", S),
                Leaf("shared_attn.ln2", (S, d), dt, norm),
                *mlp("shared_attn", S)]
    else:
        raise ValueError(f"no weights for family {m['family']!r}")
    return out


def leaf_seed(seed: int, index: int) -> int:
    """The generator seed of leaf ``index`` of run ``seed`` (any whole
    number: it is folded into 63 bits)."""
    return (int(seed) * 1_000_003 + 7919 * (index + 1)) % (1 << 63)


def make_leaf(leaf: Leaf, seed: int, index: int,
              device: torch.device) -> torch.Tensor:
    """One leaf, from its own generator on ``device``, in one call."""
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, index))
    kind = leaf.init[0]
    if kind == "ones":
        return torch.ones(leaf.shape, dtype=leaf.dtype, device=device)
    if kind == "normal":
        w = torch.randn(leaf.shape, generator=gen, device=device,
                        dtype=leaf.dtype)
        return w.mul_(leaf.init[1])
    lo, hi = leaf.init[1], leaf.init[2]
    u = torch.rand(leaf.shape, generator=gen, device=device,
                   dtype=torch.float32)
    if kind == "log_uniform":                    # A_log = log U(lo, hi)
        return torch.log(lo + (hi - lo) * u).to(leaf.dtype)
    if kind == "dt_bias":                        # softplus^-1 of a dt
        dt = torch.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * u)
        return (dt + torch.log(-torch.expm1(-dt))).to(leaf.dtype)
    raise ValueError(f"unknown init {leaf.init!r}")


def make(m: dict, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """Every leaf of the model, by path."""
    return {lf.path: make_leaf(lf, seed, i, device)
            for i, lf in enumerate(leaves(m))}


def nest(flat: dict[str, torch.Tensor]) -> dict:
    """The program's nested parameter tree from paths."""
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *heads, last = path.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = t
    return tree


def get(tree: dict, path: str):
    """The leaf at ``path`` of a nested tree."""
    for key in path.split("."):
        tree = tree[key]
    return tree
