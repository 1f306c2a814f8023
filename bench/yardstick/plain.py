"""Plain PyTorch pieces of the references (``bench/configs/ref_*.py``):
RMSNorm, rotary embeddings, causal GQA attention, the SwiGLU MLP, the
causal depthwise convolution and the Mamba-2 scan in its chunked (SSD)
form, all in float32 and written from the equations, with no kernel and
nothing of the program.

``fp8`` runs the control: the reference computed one precision below the
configuration's bfloat16, in float8 e4m3 wherever the program holds a
tensor in bfloat16 and in float32 where the program does (the Mamba-2
dt, the scan, the norms' arithmetic, the softmax).  ``low`` rounds a
tensor to float8 with one scale a tensor (amax / 448) and its gradient
likewise in the backward: each weight product's operands and output, the
residual stream after each addition, the embedding, the convolution's and
the activations' outputs.  The caller turns TF32 off
(``torch.backends.cuda.matmul.allow_tf32``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 at one scale for the whole tensor, back
    in float32."""
    scale = t.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Low(torch.autograd.Function):
    """float8 rounding forward, and of the gradient backward."""

    @staticmethod
    def forward(ctx, t):
        return to_fp8(t)

    @staticmethod
    def backward(ctx, g):
        return to_fp8(g)


def low(t: torch.Tensor, fp8: bool) -> torch.Tensor:
    """``t`` as the control holds it: in float8 when ``fp8``, else as is."""
    return _Low.apply(t) if fp8 else t


def mm(a: torch.Tensor, w: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    return low(low(a, fp8) @ low(w, fp8), fp8)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x / rms(x) * (1 + w): the weight is centred on zero."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1 + w)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on split halves; x (B, T, heads, D) at positions
    0 .. T-1."""
    T, D = x.shape[1], x.shape[-1]
    half = D // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> torch.Tensor:
    """softmax(q k^T / sqrt(D), causal) v; q (B, T, H, D), k and v
    (B, T, K, D), query head h reading kv head h // (H / K)."""
    H, K, D = q.shape[2], k.shape[2], q.shape[3]
    k = k.repeat_interleave(H // K, dim=2)
    v = v.repeat_interleave(H // K, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q, k) * D ** -0.5
    T = q.shape[1]
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhts,bshd->bthd", torch.softmax(s, dim=-1), v)


def attention_block(p: dict, h: torch.Tensor, m: dict, fp8: bool
                    ) -> torch.Tensor:
    """Projections, rope, causal attention, output projection."""
    B, T, d = h.shape
    H, K, Dh = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = mm(h, p["wq"].reshape(d, H * Dh), fp8).view(B, T, H, Dh)
    k = mm(h, p["wk"].reshape(d, K * Dh), fp8).view(B, T, K, Dh)
    v = mm(h, p["wv"].reshape(d, K * Dh), fp8).view(B, T, K, Dh)
    q = low(rope(q, m["rope_theta"]), fp8)
    k = low(rope(k, m["rope_theta"]), fp8)
    o = causal_attention(q, k, v).reshape(B, T, H * Dh)
    return mm(o, p["wo"].reshape(H * Dh, d), fp8)


def act(x: torch.Tensor, kind: str) -> torch.Tensor:
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


def mlp_block(p: dict, h: torch.Tensor, m: dict, fp8: bool) -> torch.Tensor:
    """act(h W_gate) * (h W_up), then W_out."""
    g = low(act(mm(h, p["wi_gate"], fp8), m["act"]), fp8)
    return mm(low(g * mm(h, p["wi_up"], fp8), fp8), p["wo"], fp8)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """Depthwise causal convolution: out_t = sum_i x_{t-K+1+i} w_i + b,
    zeros before the start; x (B, T, C), w (K, C)."""
    K, T = w.shape[0], x.shape[1]
    xin = F.pad(x, (0, 0, K - 1, 0))
    return sum(xin[:, i:i + T] * w[i] for i in range(K)) + b


def ssd_scan(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, A: torch.Tensor, chunk: int = 64
             ) -> torch.Tensor:
    """The Mamba-2 recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t b_t^T,
    y_t = h_t c_t, from h = 0, computed chunk by chunk (SSD): within a
    chunk y = (L o C B^T) diag(dt) X with L[i, j] = exp(sum_{j<k<=i} dt_k
    A), the state carried between chunks.  dt (B, T, H), x (B, T, H, P),
    b and c (B, T, N) shared by the heads, A (H,); returns y (B, T, H, P)."""
    Bn, T, H, P = x.shape
    N, Q = b.shape[-1], chunk
    pad = -T % Q
    if pad:
        dt, b, c = (F.pad(t, (0, 0, 0, pad)) for t in (dt, b, c))
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
    nc = (T + pad) // Q
    cs = (dt * A).view(Bn, nc, Q, H).cumsum(2)             # (B, nc, Q, H)
    seg = cs[:, :, :, None] - cs[:, :, None]               # (B, nc, i, j, H)
    lower = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    L = torch.exp(seg.masked_fill(~lower[:, :, None], float("-inf")))
    bq, cq = b.view(Bn, nc, Q, N), c.view(Bn, nc, Q, N)
    xd = (x * dt[..., None]).view(Bn, nc, Q, H, P)
    M = L * torch.einsum("bcin,bcjn->bcij", cq, bq)[..., None]
    y = torch.einsum("bcijh,bcjhp->bcihp", M, xd)
    to_end = torch.exp(cs[:, :, -1:] - cs)                 # (B, nc, Q, H)
    local = torch.einsum("bcjh,bcjhp,bcjn->bchpn", to_end, xd, bq)
    h = x.new_zeros(Bn, H, P, N)
    carried = []
    for i in range(nc):
        carried.append(h)
        h = torch.exp(cs[:, i, -1])[..., None, None] * h + local[:, i]
    h_in = torch.stack(carried, 1)                         # (B, nc, H, P, N)
    y = y + torch.einsum("bcin,bchpn->bcihp", cq, h_in) \
        * torch.exp(cs)[..., None]
    return y.reshape(Bn, nc * Q, H, P)[:, :T]


def mamba2_block(p: dict, h: torch.Tensor, m: dict, fp8: bool
                 ) -> torch.Tensor:
    """The Mamba-2 mixer of a zamba2 layer: in projection, causal conv and
    SiLU, b and c from their own projection, dt = softplus(h W_dt + bias)
    (a float32 product), the scan with A = -exp(A_log), the skip D x, the
    gated RMSNorm, the out projection."""
    Bn, T, d = h.shape
    di = m["ssm_expand"] * d
    n, hd = m["ssm_state"], m["ssm_head_dim"]
    H = di // hd
    xs, z = mm(h, p["in_proj"], fp8).split(di, dim=-1)
    xs = low(F.silu(low(causal_conv(xs, p["conv_w"], p["conv_b"]), fp8)),
             fp8)
    bc, cc = mm(h, p["bc_proj"], fp8).split(n, dim=-1)
    dt = F.softplus(h @ p["dt_proj_h"] + p["dt_bias"])
    xh = xs.view(Bn, T, H, hd)
    y = ssd_scan(dt, xh, bc, cc, -torch.exp(p["A_log"]))
    y = (y + p["D"][:, None] * xh).reshape(Bn, T, di)
    y = rms_norm(y * F.silu(z), p["norm_w"], m["norm_eps"])
    return mm(y, p["out_proj"], fp8)


def layer_slices(P: dict, prefix: str) -> list[dict]:
    """The per-layer views of every stacked leaf under ``prefix`` (one
    ``unbind`` a leaf, so that the backward stacks the layers' gradients
    once), as nested dicts keyed by the path below the prefix."""
    keys = [k for k in P if k.startswith(prefix + ".")]
    parts = {k[len(prefix) + 1:]: P[k].unbind(0) for k in keys}
    n = len(next(iter(parts.values())))
    out = []
    for i in range(n):
        layer: dict = {}
        for path, ts in parts.items():
            node = layer
            *heads, last = path.split(".")
            for hd in heads:
                node = node.setdefault(hd, {})
            node[last] = ts[i]
        out.append(layer)
    return out


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor
                    ) -> torch.Tensor:
    """Mean cross-entropy of each position against the next token."""
    lg = logits[:, :-1]
    gold = torch.take_along_dim(lg, tokens[:, 1:, None].long(), dim=-1)[..., 0]
    return (torch.logsumexp(lg, dim=-1) - gold).mean()
