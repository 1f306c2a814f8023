"""Mixture-of-Experts layer (PyTorch port of ``repro/models/moe.py``).

Top-k routing with capacity-bounded dispatch, as the reference: each
token's k (expert, weight) assignments are flattened, sorted by expert id
(a stable sort, as ``jnp.argsort``), and the first ``C`` of each expert's
segment are copied into an (E, C, d) buffer; the experts' FFNs run as three
batched products over the expert dim; each kept assignment's output is
gathered back, weighted, and the k contributions of a token are summed.
Assignments past an expert's capacity are dropped.

The reference adds into the buffer and into the output with ``.at[].add``;
on a card the port's equivalents with repeated indices would add by
atomics, in an order that changes from run to run.  The port writes the
buffer with unique slots (dropped assignments go to one spare row that is
cut off) and sums a token's k contributions after undoing the sort, so a
forward is bit-for-bit repeatable.

Under remat "dots" (``layers.remat_policy``) the router and the shared MLP
dispatch as ``aten.mm`` and are saved; the grouped products dispatch as
``aten.bmm`` and are recomputed, as the reference recomputes its
batch-dim dots.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers
from repro_torch.models.layers import Params, dense_init


def init_moe_params(gen: torch.Generator, d_model: int, cfg,
                    dtype: torch.dtype) -> Params:
    """The reference's leaves: ``router`` (d, E) in float32 whatever
    ``dtype``; ``wi_gate``, ``wi_up`` (E, d, f) and ``wo`` (E, f, d), each
    made contiguous after the reference's transpose; ``shared`` when the
    config has a shared expert."""
    E, f = cfg.n_experts, cfg.moe_d_ff
    p = {
        "router": dense_init(gen, d_model, (E,), torch.float32),
        "wi_gate": dense_init(gen, d_model, (E, f), dtype
                              ).transpose(0, 1).contiguous(),
        "wi_up": dense_init(gen, d_model, (E, f), dtype
                            ).transpose(0, 1).contiguous(),
        "wo": dense_init(gen, f, (E, d_model), dtype
                         ).transpose(0, 1).contiguous(),
    }
    if cfg.shared_expert_d_ff:
        p["shared"] = layers.init_mlp_params(gen, d_model,
                                             cfg.shared_expert_d_ff, dtype)
    return p


def route(params: Params, xf: torch.Tensor, k: int
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(weights, experts), each (N, k): the top-k of the softmax of the
    float32 router logits, renormalised to sum to one."""
    probs = torch.softmax(xf.float() @ params["router"], dim=-1)
    weights, experts = torch.topk(probs, k, dim=-1)
    return weights / weights.sum(-1, keepdim=True).clamp_min(1e-9), experts


def capacity(capacity_factor: float, k: int, N: int, E: int) -> int:
    """Slots per expert: the reference's ``max(1, int(cf * k * N / E))``."""
    return max(1, int(capacity_factor * k * N / E))


def dispatch(experts: torch.Tensor, E: int, C: int
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(order, keep, slot) of the N*k assignments ``experts.reshape(-1)``:
    the stable sort by expert id (assignment i is token i // k), whether
    each sorted assignment is among the first C of its expert, and its row
    ``expert * C + position`` of the (E*C, d) buffer."""
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)
    se = flat[order]
    seg_start = torch.searchsorted(se, torch.arange(E, device=flat.device))
    pos_in_e = torch.arange(flat.numel(), device=flat.device) - seg_start[se]
    return order, pos_in_e < C, se * C + pos_in_e


def moe_block(params: Params, x: torch.Tensor, cfg, *,
              capacity_factor: float = 1.25) -> torch.Tensor:
    """x: (B, T, d) -> (B, T, d)."""
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.n_experts_active
    N = B * T
    xf = x.reshape(N, d)
    weights, experts = route(params, xf, k)
    C = capacity(capacity_factor, k, N, E)
    order, keep, slot = dispatch(experts, E, C)
    sw = weights.reshape(-1)[order]

    # kept assignments to unique rows, dropped ones to the spare row E*C
    spare = torch.where(keep, slot, E * C)
    buf = x.new_zeros((E * C + 1, d)).index_put((spare,), xf[order // k])
    buf = buf[:E * C].view(E, C, d)

    # grouped expert FFN: (E, C, d) x (E, d, f)
    g = layers._act(torch.bmm(buf, params["wi_gate"]), cfg.act)
    u = torch.bmm(buf, params["wi_up"])
    out_e = torch.bmm(g * u, params["wo"]).view(E * C, d)

    # gather back, weight, undo the sort and sum each token's k outputs;
    # a dropped assignment (weight 0) reads row i % (E*C), not one shared
    # row: the gather's backward adds each row's reads one after another,
    # so thousands of drops on one row would serialize there
    src = torch.where(keep, slot,
                      torch.arange(N * k, device=x.device) % (E * C))
    gathered = out_e[src] * (sw * keep).to(x.dtype)[:, None]
    inverse = torch.empty_like(order).scatter_(
        0, order, torch.arange(N * k, device=x.device))
    out = gathered[inverse].view(N, k, d).sum(1).view(B, T, d)

    if "shared" in params:
        out = out + layers.mlp_block(params["shared"], x, cfg.act)
    return out
