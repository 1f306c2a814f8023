"""State-space (Mamba) blocks (PyTorch port of ``repro/models/ssm.py``):
Mamba-1 (falcon-mamba) and Mamba-2 (zamba2).

The reference runs the selective scan as a chunked associative scan
(``fused_ssm_scan``, ``CHUNK`` steps a chunk for Mamba-1, ``CHUNK // 4`` for
Mamba-2) so that the (B, T, d_inner, n) decay and input products exist one
chunk at a time; the port calls ``kernels.ops.selective_scan`` (Mamba-1) and
``kernels.ops.mamba2_scan`` (Mamba-2), whose Hopper kernels build them in
registers step by step and never store them.  ``chunked_selective_scan`` is
the reference's plain chunked scan over given (decay, inp), kept for parity.

Decode is the O(1) recurrent step on the carried (conv_state, ssm_state).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import Params, dense_init, fsdp, rms_norm
from repro_torch.sharding.context import constrain


def _channels(xz: torch.Tensor) -> torch.Tensor:
    """The input projection's output pinned to (batch, -, 'model') under a
    mesh (the identity without one): its gradient then comes back in that
    layout, where the conv's backward along the sequence would leave it
    sequence-sharded, a strided shard once the projection's weight
    gradient flattens (batch, sequence)."""
    return constrain(xz, ("pod", "data"), None, "model")

CHUNK = 256


def _assoc_scan(a: torch.Tensor, b: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan over axis 1 of the pairs (a, b) under
    ``(a1, b1) then (a2, b2) = (a2 * a1, a2 * b1 + b2)``, by doubling."""
    s = 1
    while s < a.shape[1]:
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return a, b


def chunked_selective_scan(decay: torch.Tensor, inp: torch.Tensor,
                           h0: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scan ``h_t = decay_t * h_{t-1} + inp_t`` over axis 1 (time).

    decay/inp: (B, T, ...); h0: (B, ...).  Returns (all h, final h).
    Within a chunk of ``CHUNK`` steps an associative scan, across chunks a
    sequential carry, as the reference.
    """
    T = decay.shape[1]
    h, outs = h0, []
    for t0 in range(0, T, CHUNK):
        a, b = _assoc_scan(decay[:, t0:t0 + CHUNK], inp[:, t0:t0 + CHUNK])
        h_all = a * h[:, None] + b
        outs.append(h_all)
        h = h_all[:, -1]
    return torch.cat(outs, dim=1), h


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x: (B, T, D); w: (K, D); state: (B, K-1, D).
    Returns the output and the new state (the last K-1 inputs)."""
    K, T = w.shape[0], x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xin = torch.cat([state, x], dim=1)
    out = xin[:, 0:T] * w[0]
    for i in range(1, K):
        out = out + xin[:, i:i + T] * w[i]
    return out + b, xin[:, -(K - 1):]


def init_mamba_params(gen: torch.Generator, cfg, dtype: torch.dtype
                      ) -> Params:
    """Mamba mixer parameters, the reference's leaves.  Mamba-1:
    ``dt_proj``, ``dt_bias``, ``A_log`` and ``D`` are float32 whatever
    ``dtype``; Mamba-2 (a scalar decay a head, H = d_inner / ssm_head_dim):
    ``dt_bias``, ``A_log`` (zeros: A = -1), ``D`` (H,) and ``dt_proj_h``
    (d, H) are float32, ``bc_proj`` and the gated norm's ``norm_w`` are in
    ``dtype``."""
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dev = gen.device
    dt_rank = max(1, d // 16)
    f32 = torch.float32
    p = {
        "in_proj": dense_init(gen, d, (2 * di,), dtype),
        "conv_w": dense_init(gen, cfg.ssm_conv, (di,), dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, di, (d,), dtype),
    }
    if cfg.mamba_version != 1:
        H = di // cfg.ssm_head_dim
        return {**p,
                "bc_proj": dense_init(gen, d, (2 * n,), dtype),
                "dt_bias": torch.zeros((H,), dtype=f32, device=dev),
                "A_log": torch.zeros((H,), dtype=f32, device=dev),
                "D": torch.ones((H,), dtype=f32, device=dev),
                "dt_proj_h": dense_init(gen, d, (H,), f32),
                "norm_w": torch.zeros((di,), dtype=dtype, device=dev)}
    return {
        **p,
        "x_proj": dense_init(gen, di, (dt_rank + 2 * n,), dtype),
        "dt_proj": dense_init(gen, dt_rank, (di,), f32),
        "dt_bias": torch.zeros((di,), dtype=f32, device=dev),
        "A_log": torch.log(torch.arange(1, n + 1, dtype=f32, device=dev)
                           ).repeat(di, 1),                       # (di, n)
        "D": torch.ones((di,), dtype=f32, device=dev),
    }


def mamba1_block(p: Params, x: torch.Tensor, cfg,
                 state: tuple[torch.Tensor, torch.Tensor] | None = None
                 ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Falcon-mamba style Mamba-1 mixer.  x: (B, T, d) -> (y (B, T, d),
    (conv_state (B, K-1, di), h_last (B, di, n) float32))."""
    di, n = cfg.d_inner, cfg.ssm_state
    dt_rank = max(1, cfg.d_model // 16)
    conv_state, h0 = state if state is not None else (None, None)

    xz = _channels(x @ fsdp(p["in_proj"]))
    xs, z = xz.split(di, dim=-1)
    xs, conv_state = causal_conv1d(xs, p["conv_w"], p["conv_b"], conv_state)
    xs = F.silu(xs)

    proj = xs @ fsdp(p["x_proj"])
    dt_in, Bc, Cc = proj.split([dt_rank, n, n], dim=-1)
    dt = F.softplus(dt_in.float() @ fsdp(p["dt_proj"]) + p["dt_bias"])  # (B,T,di)
    A = -torch.exp(p["A_log"])                                     # (di, n)
    if h0 is None:
        h0 = torch.zeros((x.shape[0], di, n), dtype=torch.float32,
                         device=x.device)

    y, h_last = ops.selective_scan(dt, xs, Bc, Cc, A, h0)
    y = y + p["D"] * xs.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    return y @ fsdp(p["out_proj"]), (conv_state, h_last)


def mamba2_block(p: Params, x: torch.Tensor, cfg,
                 state: tuple[torch.Tensor, torch.Tensor] | None = None
                 ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Zamba2-style Mamba-2 mixer: a scalar decay a head, b and c shared by
    the heads, then the gated RMSNorm.  x: (B, T, d) -> (y (B, T, d),
    (conv_state (B, K-1, di), h_last (B, H, head_dim, n) float32))."""
    di, n, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    H = di // hd
    B, T, _ = x.shape
    conv_state, h0 = state if state is not None else (None, None)

    xz = _channels(x @ fsdp(p["in_proj"]))
    xs, z = xz.split(di, dim=-1)
    xs, conv_state = causal_conv1d(xs, p["conv_w"], p["conv_b"], conv_state)
    xs = F.silu(xs)

    Bc, Cc = (x @ fsdp(p["bc_proj"])).split(n, dim=-1)              # (B,T,n) each
    dt = F.softplus(x.float() @ fsdp(p["dt_proj_h"]) + p["dt_bias"])  # (B,T,H)
    A = -torch.exp(p["A_log"])                                  # (H,)
    xh = xs.view(B, T, H, hd)
    if h0 is None:
        h0 = torch.zeros((B, H, hd, n), dtype=torch.float32, device=x.device)

    y, h_last = ops.mamba2_scan(dt, xh, Bc, Cc, A, h0)
    y = (y + p["D"][:, None] * xh.float()).reshape(B, T, di)
    y = rms_norm(y * F.silu(z.float()), p["norm_w"], cfg.norm_eps).to(x.dtype)
    return y @ fsdp(p["out_proj"]), (conv_state, h_last)
