"""Plain PyTorch versions of the port's kernels (the allclose targets).

Each function computes what its kernel computes, the straightforward way;
the kernel wrappers use them for tensors that lie on the CPU, and the tests
and ``chip_smoke.py`` hold the kernels against them on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _mask(Tq: int, Tk: int, causal: bool, window: int,
          device: torch.device) -> torch.Tensor:
    """(Tq, Tk) bool, True where query t may attend to key s."""
    qpos = torch.arange(Tq, device=device)[:, None]
    kpos = torch.arange(Tk, device=device)[None, :]
    ok = torch.ones((Tq, Tk), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= (qpos - kpos) < window
    return ok


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0, return_lse: bool = False):
    """Materialized-scores attention oracle.

    q: (BH, Tq, D); k, v: (BH, Tk, D).  Scores in float32, masked entries
    filled with the finite ``NEG_INF`` (as ``repro/kernels/ref.py``), output
    cast back to ``q.dtype``.  With ``return_lse`` also the row
    log-sum-exp (BH, Tq), float32, in natural-log units of the scaled and
    soft-capped scores: the softmax is ``exp(s - lse)``.
    """
    D = q.shape[-1]
    Tq, Tk = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (D ** -0.5)
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    ok = _mask(Tq, Tk, causal, window, q.device)
    s = torch.where(ok[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1)
    return o


def _heads_major(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q (B, Tq, H, D), k/v (B, Tk, K, D) -> (B*H, T, D) each, K/V
    broadcast G-fold (head h reads kv head h // G, ``repro/kernels/ops.py``)."""
    B, Tq, H, D = q.shape
    Tk, K = k.shape[1], k.shape[2]
    G = H // K
    qf = q.permute(0, 2, 1, 3).reshape(B * H, Tq, D)
    kf = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).reshape(
        B * H, Tk, D)
    vf = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).reshape(
        B * H, Tk, D)
    return qf, kf, vf


def flash_attention_gqa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            *, causal: bool = True, window: int = 0,
                            softcap: float = 0.0, return_lse: bool = False):
    """q: (B, Tq, H, D); k, v: (B, Tk, K, D) -> (B, Tq, H, D), through
    ``flash_attention_ref`` with the reference wrapper's G-fold K/V
    broadcast; with ``return_lse`` also the row LSE (B, H, Tq), float32."""
    B, Tq, H, D = q.shape
    out = flash_attention_ref(*_heads_major(q, k, v), causal=causal,
                              window=window, softcap=softcap,
                              return_lse=return_lse)
    o, lse = out if return_lse else (out, None)
    o = o.reshape(B, H, Tq, D).permute(0, 2, 1, 3)
    return (o, lse.reshape(B, H, Tq)) if return_lse else o


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, lse: torch.Tensor,
                            do: torch.Tensor, *, causal: bool = True,
                            window: int = 0, softcap: float = 0.0):
    """The gradient of ``flash_attention_gqa_ref``, step by step, with
    materialized scores, all in float32.

    q, o, do: (B, Tq, H, D); k, v: (B, Tk, K, D); lse: (B, H, Tq), the
    forward's.  Returns dq, dk, dv in the dtypes of q, k, v:
    Δ = rowsum(dO∘O); P = exp(S - lse); dV = Pᵀ dO; dP = dO Vᵀ;
    dS = P∘(dP - Δ), times 1 - tanh²(s/cap) under a soft-cap;
    dQ = scale·dS K, dK = scale·dSᵀ Q; dK and dV summed over the G query
    heads of each kv head.
    """
    B, Tq, H, D = q.shape
    Tk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = D ** -0.5
    qf, kf, vf = (t.float() for t in _heads_major(q, k, v))
    of, dof = (t.float().permute(0, 2, 1, 3).reshape(B * H, Tq, D)
               for t in (o, do))
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
    if softcap > 0.0:
        th = torch.tanh(s / softcap)
        s = softcap * th
    ok = _mask(Tq, Tk, causal, window, q.device)[None]
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    delta = (dof * of).sum(dim=-1)                              # (BH, Tq)
    p = torch.exp(s - lse.reshape(B * H, Tq, 1).float())
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    dp = torch.einsum("bqd,bkd->bqk", dof, vf)
    ds = p * (dp - delta[..., None])
    if softcap > 0.0:
        ds = ds * (1.0 - th * th)
    dq = torch.einsum("bqk,bkd->bqd", ds, kf) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, qf) * scale

    def kv_heads(t):          # (B*H, Tk, D) -> (B, Tk, K, D), summed over G
        return t.reshape(B, K, G, Tk, D).sum(dim=2).permute(0, 2, 1, 3)

    dq = dq.reshape(B, H, Tq, D).permute(0, 2, 1, 3)
    return (dq.to(q.dtype), kv_heads(dk).to(k.dtype),
            kv_heads(dv).to(v.dtype))


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


def mamba2_scan_ref(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor, A: torch.Tensor, h0: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-2 recurrence with its inputs built step by step.

    dt: (B, T, H); x: (B, T, H, P); b, c: (B, T, N), shared by every head;
    A: (H,); h0: (B, H, P, N).  ``decay_t = exp(dt_t * A)`` is a scalar a
    head, ``u_t = (dt_t * x_t) * b_t`` fills a head's (P, N) state,
    ``h_t = decay_t * h_{t-1} + u_t`` and ``y_t = sum_n h_t * c_t``; all in
    float32, as ``make_chunk``/``emit_chunk`` of the reference's
    ``mamba2_block``.  Returns y (B, T, H, P) and the last state
    (B, H, P, N), float32.
    """
    dt, x, b, c = dt.float(), x.float(), b.float(), c.float()
    A = A.float()
    h = h0.float()
    ys = []
    for t in range(dt.shape[1]):
        decay = torch.exp(dt[:, t] * A)[..., None, None]
        u = (dt[:, t, :, None] * x[:, t])[..., None] * b[:, t, None, None, :]
        h = decay * h + u
        ys.append((h * c[:, t, None, None, :]).sum(dim=-1))
    return torch.stack(ys, dim=1), h


def mamba2_scan_bwd_ref(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor, A: torch.Tensor, h0: torch.Tensor,
                        dy: torch.Tensor, dh_last: torch.Tensor
                        ) -> tuple[torch.Tensor, ...]:
    """The gradient of ``mamba2_scan_ref``, step by step, all in float32.

    From the forward's inputs, dy (B, T, H, P) and dh_last (B, H, P, N),
    with ``a_t = dt_t A``, ``decay_t = exp(a_t)`` and g the state's
    gradient, walking t from T - 1 down:
    ``g_t = decay_{t+1} g_{t+1} + dy_t ⊗ c_t`` (``g_{T-1} = dh_last +
    dy_{T-1} ⊗ c_{T-1}``); ``dc_t = Σ_{h,p} dy_t h_t``;
    ``dx_t = dt_t (g_t b_t)``; ``db_t = Σ_h dt_t (x_tᵀ g_t)``;
    ``da_t = decay_t ⟨g_t, h_{t-1}⟩``; ``ddt_t = A da_t + ⟨g_t, x_t ⊗
    b_t⟩``; ``dA = Σ_{b,t} dt_t da_t``; ``dh0 = decay_0 g_0``.  Returns
    ddt (B, T, H) float32, dx in x's dtype, db and dc in b's and c's, dA
    (H,) and dh0 (B, H, P, N) float32.
    """
    dtf, xf, bf, cf = dt.float(), x.float(), b.float(), c.float()
    Af = A.float()
    decay = torch.exp(dtf * Af)                                 # (B, T, H)
    hs = [h0.float()]                  # hs[t + 1] is h_t, hs[0] is h0
    for t in range(dt.shape[1]):
        u = (dtf[:, t, :, None] * xf[:, t])[..., None] * bf[:, t, None,
                                                            None, :]
        hs.append(decay[:, t, :, None, None] * hs[-1] + u)
    g = dh_last.float()
    ddt, dx, db, dc, da = ([None] * dt.shape[1] for _ in range(5))
    for t in reversed(range(dt.shape[1])):
        g = g + dy[:, t].float()[..., None] * cf[:, t, None, None, :]
        gb = torch.einsum("bhpn,bn->bhp", g, bf[:, t])
        dc[t] = torch.einsum("bhp,bhpn->bn", dy[:, t].float(), hs[t + 1])
        dx[t] = dtf[:, t, :, None] * gb
        db[t] = torch.einsum("bh,bhp,bhpn->bn", dtf[:, t], xf[:, t], g)
        da[t] = decay[:, t] * torch.einsum("bhpn,bhpn->bh", g, hs[t])
        ddt[t] = Af * da[t] + torch.einsum("bhp,bhp->bh", xf[:, t], gb)
        g = decay[:, t, :, None, None] * g
    da = torch.stack(da, dim=1)
    return (torch.stack(ddt, dim=1), torch.stack(dx, dim=1).to(x.dtype),
            torch.stack(db, dim=1).to(b.dtype),
            torch.stack(dc, dim=1).to(c.dtype), (dtf * da).sum(dim=(0, 1)),
            g)


def _bf16_terms(v: torch.Tensor, terms: int) -> list[torch.Tensor]:
    """``v`` as ``terms`` bfloat16 values (in float32) as the chunked kernel
    splits it: each term but the last the top 16 bits of what the terms
    before it left (a truncation), the last its nearest bfloat16; ``[v]``
    itself at 0."""
    if terms == 0:
        return [v]
    parts = []
    for i in range(terms):
        if i < terms - 1:
            part = (v.view(torch.int32) & -65536).view(torch.float32)
        else:
            part = v.to(torch.bfloat16).float()
        parts.append(part)
        v = v - part
    return parts


def mamba2_scan_chunked_ref(dt: torch.Tensor, x: torch.Tensor,
                            b: torch.Tensor, c: torch.Tensor, A: torch.Tensor,
                            h0: torch.Tensor, chunk: int = 64,
                            bf16_terms: int = 0
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``mamba2_scan_ref``'s function in the chunked state-space-duality
    (SSD) form that ``csrc/mamba_scan.cu``'s chunked path computes; for the
    tests (the ``mamba2_scan`` wrapper takes ``mamba2_scan_ref`` on the
    CPU).

    Chunks of ``chunk`` steps (the last padded with dt = 0, x = b = c = 0).
    With ``a_k = dt_k A`` and the segment sums ``S[i, j] = sum_{j<k<=i} a_k``
    (running sums down each column, never a difference of two running
    sums), ``L = exp(S)`` below the diagonal and 0 above, a chunk gives
    ``y = (L o C B^T) diag(dt) X + diag(exp(S[i, -1])) C h^T`` and passes on
    ``h = exp(S[Q-1, -1]) h + X^T diag(dt_j exp(S[Q-1, j])) B``.
    ``bf16_terms`` > 0 emulates the kernel's tensor-core products: the
    float32 side of the last three (M = L o C B^T diag(dt), h and
    diag(w) B) is that many bfloat16 terms, each multiplied and summed in
    float32.  Returns y (B, T, H, P) and the last state (B, H, P, N),
    float32.
    """
    dt, x, b, c = dt.float(), x.float(), b.float(), c.float()
    A, h = A.float(), h0.float()
    B, T, H, P = x.shape
    Q = chunk
    pad = -T % Q
    if pad:
        dt = F.pad(dt, (0, 0, 0, pad))
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    lower = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    below = lower.tril(-1)

    def products(f32, other, f32_first):
        return sum((p @ other if f32_first else other @ p)
                   for p in _bf16_terms(f32, bf16_terms))

    ys = []
    for t0 in range(0, T + pad, Q):
        dc = dt[:, t0:t0 + Q].transpose(1, 2)            # (B, H, Q)
        xc = x[:, t0:t0 + Q].transpose(1, 2)             # (B, H, Q, P)
        bc, cc = b[:, None, t0:t0 + Q], c[:, None, t0:t0 + Q]  # (B, 1, Q, N)
        a = dc * A[:, None]
        S = torch.cumsum(a[..., :, None].expand(B, H, Q, Q)
                         .masked_fill(~below, 0.), dim=-2)
        L = torch.exp(S).masked_fill(~lower, 0.)
        e = torch.exp(torch.cumsum(a, dim=-1))           # exp(S[i, -1])
        w = dc * torch.exp(S[..., -1, :])                # dt_j exp(S[Q-1, j])
        M = L * (cc @ bc.transpose(-1, -2)) * dc[..., None, :]
        y = (e[..., None] * products(h, cc.transpose(-1, -2), True)
             .transpose(-1, -2) + products(M, xc, True))
        h = (e[..., -1, None, None] * h
             + products(w[..., None] * bc, xc.transpose(-1, -2), False))
        ys.append(y.transpose(1, 2))
    return torch.cat(ys, dim=1)[:, :T], h


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
