"""Plain PyTorch versions of the port's kernels (the allclose targets).

Each function computes what its kernel computes, the straightforward way;
the kernel wrappers use them for tensors that lie on the CPU, and the tests
and ``chip_smoke.py`` hold the kernels against them on the card.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """Materialized-scores attention oracle.

    q: (BH, Tq, D); k, v: (BH, Tk, D).  Scores in float32, masked entries
    filled with the finite ``NEG_INF`` (as ``repro/kernels/ref.py``), output
    cast back to ``q.dtype``.
    """
    D = q.shape[-1]
    Tq, Tk = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (D ** -0.5)
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(Tq, device=q.device)[:, None]
    kpos = torch.arange(Tk, device=q.device)[None, :]
    ok = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= (qpos - kpos) < window
    s = torch.where(ok[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_attention_gqa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            *, causal: bool = True, window: int = 0,
                            softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Tq, H, D); k, v: (B, Tk, K, D) -> (B, Tq, H, D), through
    ``flash_attention_ref`` with the reference wrapper's G-fold K/V
    broadcast (head h reads kv head h // G, ``repro/kernels/ops.py``)."""
    B, Tq, H, D = q.shape
    Tk, K = k.shape[1], k.shape[2]
    G = H // K
    qf = q.permute(0, 2, 1, 3).reshape(B * H, Tq, D)
    kf = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).reshape(
        B * H, Tk, D)
    vf = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).reshape(
        B * H, Tk, D)
    out = flash_attention_ref(qf, kf, vf, causal=causal, window=window,
                              softcap=softcap)
    return out.reshape(B, H, Tq, D).permute(0, 2, 1, 3)


def mamba_scan_ref(decay: torch.Tensor, u: torch.Tensor, c: torch.Tensor
                   ) -> torch.Tensor:
    """Sequential selective scan, the TPU kernel's contract.

    decay, u: (B, T, D, N); c: (B, T, N) -> y: (B, T, D) float32, with
    ``h_t = decay_t * h_{t-1} + u_t``, ``h_{-1} = 0`` and
    ``y_t = sum_n h_t * c_t``, all in float32.
    """
    decay, u, c = decay.float(), u.float(), c.float()
    B, T, D, N = decay.shape
    h = torch.zeros((B, D, N), dtype=torch.float32, device=decay.device)
    ys = []
    for t in range(T):
        h = decay[:, t] * h + u[:, t]
        ys.append((h * c[:, t, None, :]).sum(dim=-1))
    return torch.stack(ys, dim=1)


def selective_scan_ref(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, A: torch.Tensor, h0: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-1 recurrence with its inputs built step by step.

    dt, x: (B, T, di); b, c: (B, T, n); A: (di, n); h0: (B, di, n).
    ``decay_t = exp(dt_t * A)``, ``u_t = (dt_t * x_t) * b_t``, then the
    recurrence of ``mamba_scan_ref`` from ``h0``; all in float32, as
    ``make_chunk``/``emit_chunk`` of the reference's ``mamba1_block``.
    Returns y (B, T, di) and the last state (B, di, n), float32.
    """
    dt, x, b, c = dt.float(), x.float(), b.float(), c.float()
    A = A.float()
    h = h0.float()
    ys = []
    for t in range(dt.shape[1]):
        decay = torch.exp(dt[:, t, :, None] * A)
        u = (dt[:, t] * x[:, t])[..., None] * b[:, t, None, :]
        h = decay * h + u
        ys.append((h * c[:, t, None, :]).sum(dim=-1))
    return torch.stack(ys, dim=1), h


def lut_matmul_ref(x: torch.Tensor, codes: torch.Tensor, lut: torch.Tensor
                   ) -> torch.Tensor:
    """Dequantize the whole weight matrix, then a float32 matmul.

    x: (M, K); codes: (K, N) uint8; lut: (K // group, N, 16) float32 with
    ``group = K // lut.shape[0]`` -> (M, N) float32.
    """
    K, N = codes.shape
    g = lut.shape[0]
    c = codes.reshape(g, K // g, N).long()
    w = torch.take_along_dim(lut.float().transpose(1, 2), c, dim=1)
    return x.float() @ w.reshape(K, N)
