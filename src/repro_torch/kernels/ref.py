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
