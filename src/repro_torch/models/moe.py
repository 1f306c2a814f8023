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

Under a ``DeviceMesh`` (``x`` a DTensor; ``_moe_block_mesh``) the
reference leaves the layout to GSPMD over its sharding rule: EP, the
experts over 'model', where ``E % tp == 0`` (llama4's 128 experts, 8 a
card on a 16-way axis), and TP, the ffn dim over 'model', otherwise
(qwen2's 60 experts; ``REPRO_MOE_TP=1`` forces it).  The port takes the
layout from the expert weights' placements and moves no token across
ranks: ``x`` arrives batch-sharded over ('pod', 'data') and replicated
over 'model', so each rank routes its own tokens and keeps the ones the
reference keeps, with the capacity ``C`` of the *global* token count.
The reference keeps, per expert, the first ``C`` assignments in global
flat order; a rank's tokens are a contiguous run of that order, so an
assignment's global position in its expert is its local position plus
the expert's assignments on the earlier batch ranks, an exclusive prefix
over the ranks' (E,) counts, which one all-gather over the batch axes
gives.  Each rank then fills a static ``(E_loc, C_buf, d)`` buffer,
``C_buf = min(C, N_local)`` (no rank sends more than its ``N_local``
tokens to one expert): under EP with the kept assignments of the
``E_loc = E / tp`` experts it holds, under TP with every kept assignment
and its ``f / tp`` columns of the ffn.  Either way a rank's output is a
partial sum over 'model', reduced once (``Partial`` -> ``Replicate``);
the weights' FSDP shards are gathered over the batch axes first, as the
dense path gathers them (``layers.fsdp``).  Where no expert dim divides
'model' every rank runs all experts whole and nothing is reduced.
"""

from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.kernels import _symbolic
from repro_torch.models import layers
from repro_torch.models.layers import Params, dense_init
from repro_torch.sharding import partition
from repro_torch.sharding.context import constrain, current_mesh


# what ``record_routing`` collects, while it is open
_routing_log: list | None = None


@contextlib.contextmanager
def record_routing():
    """Collects, for each ``moe_block`` call while it is open (a remat
    recompute is a call), the routing ``_experts`` ran: this rank's
    ``experts`` (N, k) and ``kept`` (N * k,), whether each assignment in
    flat (token, slot) order was kept.  Under a mesh these are the local
    tokens' and, under EP, only the assignments to this rank's experts."""
    global _routing_log
    prev, _routing_log = _routing_log, []
    try:
        yield _routing_log
    finally:
        _routing_log = prev


def _record(experts: torch.Tensor, order: torch.Tensor,
            keep: torch.Tensor) -> None:
    if _routing_log is not None:
        kept = torch.empty_like(keep).scatter_(0, order, keep)
        _routing_log.append((experts.detach().clone(), kept))


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
    return _top_k(xf.float() @ params["router"], k)


def _top_k(logits: torch.Tensor, k: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    probs = torch.softmax(logits, dim=-1)
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
    if _symbolic.is_dtensor(x) and current_mesh() is not None:
        return _moe_block_mesh(params, x, cfg, capacity_factor)
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.n_experts_active
    N = B * T
    xf = x.reshape(N, d)
    weights, experts = route(params, xf, k)
    C = capacity(capacity_factor, k, N, E)
    order, keep, slot = dispatch(experts, E, C)
    _record(experts, order, keep)
    sw = weights.reshape(-1)[order]
    out = _experts(xf, order, keep, slot, sw, k, C,
                   (params["wi_gate"], params["wi_up"], params["wo"]),
                   cfg.act).view(B, T, d)

    if "shared" in params:
        out = out + layers.mlp_block(params["shared"], x, cfg.act)
    return out


def _experts(xf: torch.Tensor, order: torch.Tensor, keep: torch.Tensor,
             slot: torch.Tensor, sw: torch.Tensor, k: int, C: int,
             w: tuple, act: str) -> torch.Tensor:
    """(N, d): the experts' FFN of the kept sorted assignments (``slot``
    their rows of the (E*C, d) buffer, E the experts of ``w`` = (wi_gate,
    wi_up, wo)), weighted by ``sw``, the sort undone and each token's k
    outputs summed."""
    N, d = xf.shape
    rows = w[0].shape[0] * C
    # kept assignments to unique rows, dropped ones to the spare row
    spare = torch.where(keep, slot, rows)
    buf = xf.new_zeros((rows + 1, d)).index_put((spare,), xf[order // k])
    buf = buf[:rows].view(-1, C, d)

    # grouped expert FFN: (E, C, d) x (E, d, f)
    g = layers._act(torch.bmm(buf, w[0]), act)
    u = torch.bmm(buf, w[1])
    out_e = torch.bmm(g * u, w[2]).view(rows, d)

    # gather back, weight, undo the sort and sum each token's k outputs;
    # a dropped assignment (weight 0) reads row i % rows, not one shared
    # row: the gather's backward adds each row's reads one after another,
    # so thousands of drops on one row would serialize there
    src = torch.where(keep, slot,
                      torch.arange(N * k, device=xf.device) % rows)
    gathered = out_e[src] * (sw * keep).to(xf.dtype)[:, None]
    inverse = torch.empty_like(order).scatter_(
        0, order, torch.arange(N * k, device=xf.device))
    return gathered[inverse].view(N, k, d).sum(1)


# --- under a DeviceMesh ----------------------------------------------------------

def expert_layout(w: torch.Tensor) -> str:
    """"ep", "tp" or "replicated": how the 'model' mesh dimension splits
    the DTensor expert weight ``w`` (E, d, f): over the experts (dim 0),
    over the ffn (dim 2), or not at all."""
    names = w.device_mesh.mesh_dim_names or ()
    if "model" not in names:
        return "replicated"
    p = w.placements[names.index("model")]
    if not p.is_shard():
        return "replicated"
    return {0: "ep", 2: "tp"}[p.dim]


def _batch_placements(x: torch.Tensor) -> list:
    """``x``'s placements with every shard of dim 0 (the batch axes) kept
    and every other mesh dimension replicated."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if p.is_shard(0) else Replicate() for p in x.placements]


def earlier_counts(counts: torch.Tensor, mesh, bpl: list) -> torch.Tensor:
    """(E,) int: for each expert, the assignments to it on the batch ranks
    before this one in global token order, from each rank's ``counts``.
    One all-gather over the batch axes (``bpl``, as ``x`` is sharded);
    the exclusive prefix of the gathered rows is cut back to this rank's
    row by DTensor's own layout of ``bpl``, the layout of ``x``'s batch
    shards, so the order holds on any torch version."""
    from torch.distributed.tensor import DTensor, Replicate

    n = math.prod(mesh.size(i) for i, p in enumerate(bpl) if p.is_shard())
    E = counts.shape[0]
    rep = [Replicate()] * mesh.ndim
    rows = DTensor.from_local(counts[None], mesh, bpl, run_check=False,
                              shape=(n, E), stride=(E, 1))
    every = rows.redistribute(mesh, rep).to_local()
    excl = every.cumsum(0) - every
    return DTensor.from_local(excl, mesh, rep, run_check=False
                              ).redistribute(mesh, bpl).to_local()[0]


def mesh_dispatch(experts: torch.Tensor, E: int, C: int, mesh, bpl: list
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(order, keep, pos) of this rank's assignments ``experts`` (N_local,
    k): the stable sort by expert id, whether each sorted assignment is
    among the first C of its expert in *global* flat order (the
    reference's kept set), and its position among this rank's assignments
    to that expert."""
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)
    se = flat[order]
    ids = torch.arange(E, device=flat.device)
    seg_start = torch.searchsorted(se, ids)
    counts = torch.searchsorted(se, ids, right=True) - seg_start
    pos = torch.arange(flat.numel(), device=flat.device) - seg_start[se]
    before = earlier_counts(counts, mesh, bpl)
    return order, before[se] + pos < C, pos


def _moe_block_mesh(params: Params, x: torch.Tensor, cfg,
                    capacity_factor: float) -> torch.Tensor:
    """``moe_block`` on DTensors: the reference's result from each rank's
    local shards (the module docstring's layout).  Every collective is a
    DTensor redistribute, so autograd carries the gradient and each
    gradient leaf keeps its parameter's placements."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    mdim = names.index("model") if "model" in names else None
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.n_experts_active
    C = capacity(capacity_factor, k, B * T, E)
    x = constrain(x, ("pod", "data"), None, None)
    bpl = _batch_placements(x)
    wg, wu, wo = (layers.fsdp(params[n]) for n in ("wi_gate", "wi_up", "wo"))
    layout = expert_layout(wg)
    partial = layout != "replicated"
    if partial:
        # wi_up as wi_gate; wo (E, f, d) over the same expert or ffn dim
        wu = _symbolic.to_layout(wu, mesh, wg.placements)
        wo = _symbolic.to_layout(wo, mesh, [
            Shard(0 if layout == "ep" else 1) if i == mdim else p
            for i, p in enumerate(wg.placements)])

    def grad_pl(placements):
        # an expert weight's gradient on this rank: a partial sum over the
        # batch ranks (its own tokens); 'model' shards it, or (replicated)
        # every 'model' rank computes it whole
        return [Partial() if b.is_shard() else p
                for p, b in zip(placements, bpl)]

    # x's, the router logits' and the output's local layout: a partial sum
    # over 'model' where 'model' splits the work (each 'model' rank routes
    # the same tokens but computes only its share)
    local_grad = [Partial() if i == mdim and partial else p
                  for i, p in enumerate(x.placements)]
    xl = x.to_local(grad_placements=local_grad)
    # the router's projection is a DTensor op, as the model's other
    # projections are; its logits go local for the top-k
    logits = x.float() @ layers._replicated(params["router"])
    wgl, wul, wol = (w.to_local(grad_placements=grad_pl(w.placements))
                     for w in (wg, wu, wo))

    Bl = xl.shape[0]
    Nl = Bl * T
    xf = xl.reshape(Nl, d)
    weights, experts = _top_k(
        logits.to_local(grad_placements=local_grad).reshape(Nl, E), k)
    order, keep, pos = mesh_dispatch(experts, E, C, mesh, bpl)
    sw = weights.reshape(-1)[order]
    se = experts.reshape(-1)[order]

    C_buf = max(1, min(C, Nl))
    if layout == "ep":
        # this rank's experts: a run of E / tp from its 'model' coordinate
        e0 = partition.local_shape_and_offset(wg.shape, mesh,
                                              wg.placements)[1][0]
        le = se - e0
        keep = keep & (le >= 0) & (le < wgl.shape[0])
    else:
        le = se
    _record(experts, order, keep)
    out = _experts(xf, order, keep, le * C_buf + pos, sw, k, C_buf,
                   (wgl, wul, wol), cfg.act).view(Bl, T, d)
    out = DTensor.from_local(out, mesh, local_grad, run_check=False,
                             shape=x.shape,
                             stride=partition.contiguous_strides(x.shape))
    if partial:
        out = out.redistribute(mesh, x.placements)

    if "shared" in params:
        out = out + layers.mlp_block(params["shared"], x, cfg.act)
    return out
