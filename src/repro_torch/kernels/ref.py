"""Plain PyTorch versions of the port's kernels (the allclose targets).

Each function computes what its kernel computes, the straightforward way;
the kernel wrappers use them for tensors that lie on the CPU, and the tests
and ``chip_smoke.py`` hold the kernels against them on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, or in float64 if it is float64 (the Mamba-2 scans'
    plain versions then run in float64, so that the tests can hold two
    orders of their sums against each other at 1e-4)."""
    return t if t.dtype == torch.float64 else t.float()


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
    ``y_t = sum_n h_t * c_t``, all in float32 (float64 when given
    float64, ``_wide``).
    """
    decay, u, c = _wide(decay), _wide(u), _wide(c)
    B, T, D, N = decay.shape
    h = torch.zeros((B, D, N), dtype=decay.dtype, device=decay.device)
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
    ``make_chunk``/``emit_chunk`` of the reference's ``mamba1_block`` (in
    float64 when given float64, ``_wide``).  Returns y (B, T, di) and the
    last state (B, di, n), float32.
    """
    dt, x, b, c = _wide(dt), _wide(x), _wide(b), _wide(c)
    A = _wide(A)
    h = _wide(h0)
    ys = []
    for t in range(dt.shape[1]):
        decay = torch.exp(dt[:, t, :, None] * A)
        u = (dt[:, t] * x[:, t])[..., None] * b[:, t, None, :]
        h = decay * h + u
        ys.append((h * c[:, t, None, :]).sum(dim=-1))
    return torch.stack(ys, dim=1), h


def selective_scan_bwd_ref(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                           c: torch.Tensor, A: torch.Tensor, h0: torch.Tensor,
                           dy: torch.Tensor, dh_last: torch.Tensor
                           ) -> tuple[torch.Tensor, ...]:
    """The gradient of ``selective_scan_ref``, step by step, in float32 (or
    float64 when given float64).

    From the forward's inputs, dy (B, T, di) and dh_last (B, di, n), with
    ``a_t = dt_t A`` and ``decay_t = exp(a_t)`` (both (di, n) a (b, t)) and
    g the state's gradient, walking t from T - 1 down:
    ``g_t = decay_{t+1} ⊙ g_{t+1} + dy_t ⊗ c_t`` (``g_{T-1} = dh_last +
    dy_{T-1} ⊗ c_{T-1}``); ``dc_t = Σ_d dy_t h_t``;
    ``dx_t = dt_t Σ_n g_t b_t``; ``db_t = Σ_d dt_t x_t g_t``;
    ``da_t = decay_t ⊙ g_t ⊙ h_{t-1}``; ``ddt_t = Σ_n A da_t +
    x_t Σ_n g_t b_t``; ``dA = Σ_{b,t} dt_t da_t``; ``dh0 = decay_0 g_0``.
    Returns ddt (B, T, di) float32, dx in x's dtype, db and dc (B, T, n) in
    b's and c's, dA (di, n) and dh0 (B, di, n) float32.
    """
    dtf, xf, bf, cf = _wide(dt), _wide(x), _wide(b), _wide(c)
    Af, dyf = _wide(A), _wide(dy)
    T = dt.shape[1]

    def decay(t):                                   # (B, di, n)
        return torch.exp(dtf[:, t, :, None] * Af)

    hs = [_wide(h0)]                    # hs[t + 1] is h_t, hs[0] is h0
    for t in range(T):
        u = (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
        hs.append(decay(t) * hs[-1] + u)
    g = _wide(dh_last)
    dA = torch.zeros_like(hs[0][0])
    ddt, dx, db, dc = ([None] * T for _ in range(4))
    for t in reversed(range(T)):
        g = g + dyf[:, t, :, None] * cf[:, t, None, :]
        gb = (g * bf[:, t, None, :]).sum(dim=-1)                 # (B, di)
        dc[t] = torch.einsum("bd,bdn->bn", dyf[:, t], hs[t + 1])
        dx[t] = dtf[:, t] * gb
        db[t] = torch.einsum("bd,bdn->bn", dtf[:, t] * xf[:, t], g)
        dec = decay(t)
        da = dec * g * hs[t]
        ddt[t] = (Af * da).sum(dim=-1) + xf[:, t] * gb
        dA = dA + (dtf[:, t, :, None] * da).sum(dim=0)
        g = dec * g
    return (torch.stack(ddt, dim=1), torch.stack(dx, dim=1).to(x.dtype),
            torch.stack(db, dim=1).to(b.dtype),
            torch.stack(dc, dim=1).to(c.dtype), dA, g)


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
    dtf, xf, bf, cf = _wide(dt), _wide(x), _wide(b), _wide(c)
    Af = _wide(A)
    decay = torch.exp(dtf * Af)                                 # (B, T, H)
    hs = [_wide(h0)]                    # hs[t + 1] is h_t, hs[0] is h0
    for t in range(dt.shape[1]):
        u = (dtf[:, t, :, None] * xf[:, t])[..., None] * bf[:, t, None,
                                                            None, :]
        hs.append(decay[:, t, :, None, None] * hs[-1] + u)
    g = _wide(dh_last)
    ddt, dx, db, dc, da = ([None] * dt.shape[1] for _ in range(5))
    for t in reversed(range(dt.shape[1])):
        g = g + _wide(dy[:, t])[..., None] * cf[:, t, None, None, :]
        gb = torch.einsum("bhpn,bn->bhp", g, bf[:, t])
        dc[t] = torch.einsum("bhp,bhpn->bn", _wide(dy[:, t]), hs[t + 1])
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
    dt, x, b, c = _wide(dt), _wide(x), _wide(b), _wide(c)
    A, h = _wide(A), _wide(h0)
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


def _pair_products(a: torch.Tensor, b: torch.Tensor, terms: int
                   ) -> torch.Tensor:
    """``a @ b`` with both sides float32, as the kernel multiplies them:
    each split into ``terms`` bfloat16 terms and the products of the
    pairs (i, j) with i + j < terms summed in float32 (the dropped pairs
    are below 2^-21 of the product); ``a @ b`` itself at 0."""
    if terms == 0:
        return a @ b
    at, bt = _bf16_terms(a, terms), _bf16_terms(b, terms)
    return sum(at[i] @ bt[j] for i in range(terms) for j in range(terms - i))


def mamba2_scan_chunked_bwd_ref(dt: torch.Tensor, x: torch.Tensor,
                                b: torch.Tensor, c: torch.Tensor,
                                A: torch.Tensor, h0: torch.Tensor,
                                dy: torch.Tensor, dh_last: torch.Tensor,
                                chunk: int = 64, bf16_terms: int = 0
                                ) -> tuple[torch.Tensor, ...]:
    """``mamba2_scan_bwd_ref``'s function in the chunked (SSD) form that
    ``csrc/mamba_scan.cu``'s chunked backward computes, stage by stage.

    With ``mamba2_scan_chunked_ref``'s notation a chunk's forward is
    ``y = M X + diag(e) C h_inᵀ`` and ``h_out = E h_in + Xᵀ diag(w) B``,
    ``M = L ∘ C Bᵀ ∘ dt_j``, ``e_i = exp(S[i, -1])``, ``w_j = dt_j ew_j``,
    ``ew_j = exp(S[Q-1, j])``, ``E = e_{Q-1}``; its backward is
      (a, b) h_in of every chunk: ``h_in[k+1] = E h_in[k] + Xᵀ diag(w) B``
          from h0 (the kernel's f32 side ``w X``);
      (c) dh_out of every chunk: ``dh_out[k-1] = E dh_out[k] +
          (diag(e) dY)ᵀ C`` from dh_last, and dh0 the walk's last value;
      (d) per chunk, with ``dMᵀ = X dYᵀ``, ``dG = dM ∘ L ∘ dt_j`` and
          ``K = dM ∘ L ∘ C Bᵀ``:
          ``dX = diag(w) B dh_outᵀ + Mᵀ dY``;
          ``dB = diag(w) X dh_out + dGᵀ C``, summed over heads;
          ``dC = diag(e) dY h_in + dG B``, summed over heads;
          the log-decay gradient ``da_k = Σ_{i≥k, j<k} (K dt_j)[i, j]
          + Σ_{i≥k} r_i + Σ_{j<k} w_j v_j + E ⟨dh_out, h_in⟩`` with
          ``r_i = e_i ⟨C_i, (dY h_in)_i⟩``, ``v_j = ⟨B_j, (X dh_out)_j⟩``,
          every sum a direct sum in float32 (the rectangle as ``Sᵀ =
          (K dt)ᵀ U``, ``U[i, k] = [i ≥ k]``, then the rows j < k of each
          column);
          ``ddt = A da + Σ_i K[i, j] + ew_j v_j`` and ``dA = Σ dt da``.
    ``bf16_terms`` > 0 emulates the kernel's tensor-core products: the
    float32 side of a product with a bf16 side is that many bfloat16
    terms; where both sides are float32 (``Mᵀ dY``, ``dY h_in``) both are
    split and the pairs of terms (i, j), i + j < ``bf16_terms``, summed.
    Returns what ``mamba2_scan_bwd_ref`` returns.
    """
    dtf, xf, bf, cf = _wide(dt), _wide(x), _wide(b), _wide(c)
    Af, dyf = _wide(A), _wide(dy)
    B, T, H, P = x.shape
    N = b.shape[2]
    Q = chunk
    pad = -T % Q
    if pad:
        dtf = F.pad(dtf, (0, 0, 0, pad))
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dyf = F.pad(dyf, (0, 0, 0, 0, 0, pad))
        bf = F.pad(bf, (0, 0, 0, pad))
        cf = F.pad(cf, (0, 0, 0, pad))
    K = (T + pad) // Q
    terms = bf16_terms

    def one(f32, other, f32_first):     # a product with one float32 side
        return sum((p @ other if f32_first else other @ p)
                   for p in _bf16_terms(f32, terms))

    lower = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    below = lower.tril(-1)
    U = lower.to(dtf.dtype)                             # U[i, k] = [i >= k]
    ch = []                                # each chunk's operands and decays
    for k in range(K):
        s = slice(k * Q, (k + 1) * Q)
        dc = dtf[:, s].transpose(1, 2)                     # (B, H, Q)
        a = dc * Af[:, None]
        S = torch.cumsum(a[..., :, None].expand(B, H, Q, Q)
                         .masked_fill(~below, 0.), dim=-2)
        ch.append(dict(
            dt=dc, L=torch.exp(S).masked_fill(~lower, 0.),
            e=torch.exp(torch.cumsum(a, dim=-1)), ew=torch.exp(S[..., -1, :]),
            E=torch.exp(a.sum(dim=-1))[..., None, None],
            X=xf[:, s].transpose(1, 2), dY=dyf[:, s].transpose(1, 2),
            Bc=bf[:, None, s], Cc=cf[:, None, s]))
    # (a, b) the state entering every chunk, forwards from h0
    h_in, h = [], _wide(h0)
    for d in ch:
        h_in.append(h)
        w = d["dt"] * d["ew"]
        h = d["E"] * h + one((w[..., None] * d["X"]).transpose(-1, -2),
                             d["Bc"], True)
    # (c) the gradient of the state leaving every chunk, backwards
    dh_out, g = [None] * K, _wide(dh_last)
    for k in reversed(range(K)):
        d = ch[k]
        dh_out[k] = g
        g = d["E"] * g + one((d["e"][..., None] * d["dY"]).transpose(-1, -2),
                             d["Cc"], True)
    dh0 = g
    # (d) every chunk's gradients
    ddt, dx, db, dc, da = [], [], [], [], []
    for k, d in enumerate(ch):
        X, dY, Bc, Cc, L, dtc = d["X"], d["dY"], d["Bc"], d["Cc"], d["L"], \
            d["dt"]
        w = dtc * d["ew"]
        G = Cc @ Bc.transpose(-1, -2)                      # C Bᵀ (exact)
        dM = one(dY, X.transpose(-1, -2), True)            # dY Xᵀ
        M = L * G * dtc[..., None, :]
        dG = dM * L * dtc[..., None, :]
        Km = dM * L * G
        dX = (w[..., None] * one(dh_out[k].transpose(-1, -2), Bc, False)
              + _pair_products(M.transpose(-1, -2), dY, terms))
        xdh = one(dh_out[k], X, False)                     # X dh_out
        v = (Bc * xdh).sum(dim=-1)                         # (B, H, Q)
        dB = w[..., None] * xdh + one(dG.transpose(-1, -2), Cc, True)
        dyh = _pair_products(dY, h_in[k], terms)           # dY h_in
        r = d["e"] * (Cc * dyh).sum(dim=-1)
        dC = d["e"][..., None] * dyh + one(dG, Bc, True)
        # Sᵀ[j, k'] = Σ_{i ≥ k'} (K dt)[i, j], then its rows j < k'
        St = (Km * dtc[..., None, :]).transpose(-1, -2) @ U
        Z = St.masked_fill(~below.transpose(0, 1), 0.).sum(dim=-2)
        rsum = torch.flip(torch.cumsum(torch.flip(r, [-1]), -1), [-1])
        qsum = F.pad(torch.cumsum(w * v, -1)[..., :-1], (1, 0))
        c0 = d["E"][..., 0, 0] * (dh_out[k] * h_in[k]).sum(dim=(-2, -1))
        dak = Z + rsum + qsum + c0[..., None]
        ddt.append(Af[:, None] * dak + Km.sum(dim=-2) + d["ew"] * v)
        da.append(dak)
        dx.append(dX)
        db.append(dB.sum(dim=1))
        dc.append(dC.sum(dim=1))
    ddt = torch.cat(ddt, dim=-1).transpose(1, 2)[:, :T]
    da = torch.cat(da, dim=-1).transpose(1, 2)[:, :T]
    dx = torch.cat(dx, dim=-2).transpose(1, 2)[:, :T]
    return (ddt, dx.to(x.dtype), torch.cat(db, dim=1)[:, :T].to(b.dtype),
            torch.cat(dc, dim=1)[:, :T].to(c.dtype),
            (dtf[:, :T] * da).sum(dim=(0, 1)), dh0)


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
