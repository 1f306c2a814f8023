"""Shared transformer layer primitives (PyTorch port of ``repro/models/layers.py``).

RMSNorm, RoPE, GQA attention with an online-softmax KV-block loop (causal,
sliding-window, logit soft-cap) and the (Sw/Ge)GLU MLP, on the reference's
parameter layout: ``wq (d,H,Dh)``, ``wk/wv (d,K,Dh)``, ``wo (H,Dh,d)``,
``wi_gate/wi_up (d,F)``, ``wo (F,d)``.

Attention that the flash kernel covers (no offset: training/forward,
prefill from an empty cache, and cross-attention over a whole source
sequence) goes to ``kernels.ops.gqa_flash_attention``;
decode (``Tq`` new tokens at ``q_offset = pos > 0`` against the cache,
masked at ``kv_len``) has no TPU kernel in the reference and stays on
``attention`` below, the plain translation of the reference's scan.

Under a ``DeviceMesh`` (``sharding.context.use_mesh``) the tensors are
DTensors: ``constrain_dp`` pins q, k, v and the MLP's hidden activations
to the batch axes, ``mlp_block(overlap=True)`` runs the tensor-parallel
FFN as the Shared-PIM rings (``core/overlap/collective_matmul``) on each
rank's shards, and a cache sharded along its sequence is written shard by
shard.  Without a mesh every pin is the identity.
"""

from __future__ import annotations

import dataclasses
import functools
from collections.abc import Mapping
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    set_checkpoint_early_stop)

from repro_torch.kernels import _symbolic, ops
from repro_torch.sharding import partition
from repro_torch.sharding.context import constrain, current_mesh, use_mesh

Params = dict[str, Any]

NEG_INF = -1e30


# --- initialization helpers ------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_shape: tuple[int, ...],
               dtype: torch.dtype) -> torch.Tensor:
    """N(0, 1/in_dim) weight of shape (in_dim, *out_shape), drawn in float32
    on ``gen``'s device and cast to ``dtype``."""
    scale = 1.0 / (in_dim ** 0.5)
    w = torch.randn((in_dim, *out_shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


# --- norms -----------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with a zero-centred weight: scales by ``1 + weight``."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    # a sharded norm weight is gathered whole (it is one row), so the
    # activation keeps its layout
    out = x * torch.rsqrt(var + eps) * (1.0 + _replicated(weight).float())
    return out.to(dt)


# --- rotary embeddings ----------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embeddings on split halves.  x: (..., T, H, Dh); positions: (..., T)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs               # (..., T, half)
    cos = torch.cos(angles)[..., None, :]                        # (..., T, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _softcap(s: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(s / cap) if cap > 0.0 else s


# --- attention -------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    window: int = 0               # >0: sliding window size
    softcap: float = 0.0
    kv_block: int = 512


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              spec: AttnSpec, *, q_offset: int = 0, is_global: bool = True,
              kv_len: int | None = None) -> torch.Tensor:
    """Online-softmax attention over KV blocks.

    q: (B, Tq, H, Dh); k, v: (B, Tk, K, Dh).  Causal with optional sliding
    window (disabled when ``is_global``) and logit soft-capping.
    ``q_offset`` is the absolute position of q[0] (decode: cache length so
    far); ``kv_len`` masks out cache positions >= kv_len.  Memory is
    O(Tq * block), never O(Tq * Tk).
    """
    B, Tq, H, Dh = q.shape
    Tk, K = k.shape[1], k.shape[2]
    G = H // K
    if _symbolic.is_dtensor(k):
        # a cache sharded along its sequence: gather it once, not a block
        # at a time
        k, v = _replicated_dim(k, 1), _replicated_dim(v, 1)
    blk = min(spec.kv_block, Tk)
    nblk = -(-Tk // blk)
    dev = q.device
    qg = (q.float() * Dh ** -0.5).reshape(B, Tq, K, G, Dh)
    qpos = q_offset + torch.arange(Tq, device=dev)                   # (Tq,)
    limit = Tk if kv_len is None else kv_len
    m = torch.full((B, Tq, K, G), NEG_INF, dtype=torch.float32, device=dev)
    lsum = torch.zeros((B, Tq, K, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Tq, K, G, Dh), dtype=torch.float32, device=dev)
    for i in range(nblk):
        kstart = i * blk
        kblk = k[:, kstart:kstart + blk].float()
        vblk = v[:, kstart:kstart + blk].float()
        n = kblk.shape[1]
        if n < blk:                   # ragged last block, zero-padded
            kblk = F.pad(kblk, (0, 0, 0, 0, 0, blk - n))
            vblk = F.pad(vblk, (0, 0, 0, 0, 0, blk - n))
        s = torch.einsum("btkgd,bskd->btkgs", qg, kblk)             # B,Tq,K,G,blk
        s = _softcap(s, spec.softcap)
        kpos = kstart + torch.arange(blk, device=dev)                # (blk,)
        delta = qpos[:, None] - kpos[None, :]                        # (Tq, blk)
        ok = (delta >= 0) & (kpos[None, :] < limit)
        if spec.window > 0 and not is_global:
            ok &= delta < spec.window
        s = s.masked_fill(~ok[None, :, None, None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        lsum = lsum * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("btkgs,bskd->btkgd", p, vblk)
        m = m_new
    out = acc / torch.clamp(lsum, min=1e-30)[..., None]
    return out.reshape(B, Tq, H, Dh).to(q.dtype)


def _replicated(w: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole on every rank; a plain tensor as it is."""
    if not _symbolic.is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    want = [Replicate()] * w.device_mesh.ndim
    return w if list(w.placements) == want else \
        w.redistribute(w.device_mesh, want)


def fsdp(w: torch.Tensor) -> torch.Tensor:
    """A weight with its shards over the batch axes ('pod', 'data')
    gathered: FSDP's all-gather before use, so a projection multiplies a
    batch-sharded activation by a weight sharded over 'model' only (eager
    DTensor would otherwise pick the matmul's layouts itself, and some of
    them shard the batch and the sequence together).  The identity on a
    plain tensor."""
    if not _symbolic.is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate, Shard

    names = w.device_mesh.mesh_dim_names or ()
    want = [Replicate() if isinstance(p, Shard) and names[i] != "model"
            else p for i, p in enumerate(w.placements)]
    return w if want == list(w.placements) else \
        w.redistribute(w.device_mesh, want)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  On DTensors each rank looks its own tokens up in
    the whole table (gathered: one (vocab, d_model) row set) and the rows
    keep the tokens' layout; the table's gradient is then a partial sum
    over the ranks that hold other tokens.  DTensor's own gather rules
    for a sharded table differ across torch versions (and some fail in
    the backward)."""
    if not _symbolic.is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    tokens = _symbolic.to_layout(tokens, mesh)
    grad = [Partial() if isinstance(p, Shard) else Replicate()
            for p in tokens.placements]
    rows = _replicated(table).to_local(grad_placements=grad)[
        tokens.to_local()]
    shape = (*tokens.shape, table.shape[-1])
    return DTensor.from_local(rows, mesh, tokens.placements, run_check=False,
                              shape=shape,
                              stride=partition.contiguous_strides(shape))


def _unsharded(placements, dim: int) -> list:
    """``placements`` with every ``Shard(dim)`` made ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    return [Replicate() if isinstance(p, Shard) and p.dim == dim else p
            for p in placements]


def _replicated_dim(t, dim: int):
    """The DTensor ``t`` with dimension ``dim`` gathered on every mesh
    dimension that shards it."""
    want = _unsharded(t.placements, dim)
    return t if want == list(t.placements) else \
        t.redistribute(t.device_mesh, want)


def _write_cache(c: torch.Tensor, new: torch.Tensor, pos: int) -> None:
    """``c[:, pos:pos + T] = new`` in place.  On a DTensor cache each rank
    writes the rows of its own shard (a slice of a sequence-sharded
    DTensor would be a gathered copy, and the write would be lost)."""
    T = new.shape[1]
    if not _symbolic.is_dtensor(c):
        c[:, pos:pos + T] = new.to(c.dtype)
        return
    mesh = c.device_mesh
    new = _symbolic.to_layout(new.to(c.dtype), mesh,
                              _unsharded(c.placements, 1)).to_local()
    shape, off = partition.local_shape_and_offset(c.shape, mesh,
                                                  c.placements)
    lo, hi = max(pos, off[1]), min(pos + T, off[1] + shape[1])
    if lo < hi:
        c.to_local()[:, lo - off[1]:hi - off[1]] = new[:, lo - pos:hi - pos]


def init_attn_params(gen: torch.Generator, d_model: int, spec: AttnSpec,
                     dtype: torch.dtype, qk_norm: bool = False) -> Params:
    p = {
        "wq": dense_init(gen, d_model, (spec.n_heads, spec.head_dim), dtype),
        "wk": dense_init(gen, d_model, (spec.n_kv_heads, spec.head_dim), dtype),
        "wv": dense_init(gen, d_model, (spec.n_kv_heads, spec.head_dim), dtype),
        "wo": dense_init(gen, spec.n_heads * spec.head_dim, (d_model,),
                         dtype).reshape(spec.n_heads, spec.head_dim, d_model),
    }
    if qk_norm:
        p["q_norm"] = torch.zeros((spec.head_dim,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.zeros((spec.head_dim,), dtype=dtype, device=gen.device)
    return p


def attn_block(params: Params, x: torch.Tensor, spec: AttnSpec, *,
               rope_theta: float, norm_eps: float, positions: torch.Tensor,
               is_global: bool = True,
               kv_cache: tuple[torch.Tensor, torch.Tensor] | None = None,
               cache_len: int | None = None,
               xkv: torch.Tensor | None = None, use_rope: bool = True,
               constrain_dp: bool = False,
               ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Projections + (cached) attention.  Returns (out, (k_all, v_all)).

    * training/prefill: ``kv_cache`` is None -> attends within x, through
      the flash kernel.
    * cached: ``kv_cache`` holds (B, S, K, Dh) tensors, written in place at
      ``cache_len`` (the reference returns an updated copy; the port saves
      the copy).  From an empty cache (``cache_len == 0``, prefill) the
      kernel attends over the T keys just written, which is what the
      reference's causal mask over the whole cache leaves; otherwise
      (decode) ``attention`` runs over the whole cache masked at
      ``cache_len + T``.
    * cross-attention (the VLM's cross blocks): ``xkv`` (B, S, d) is the
      key/value source; every query attends to all S keys through the
      kernel, non-causally, which is what the reference's
      ``q_offset=S`` leaves of its causal test.  Returns (k, v) of xkv.
    * ``constrain_dp`` pins q, k and v to the batch axes (DP-stationary
      projections), the identity without a mesh.
    """
    del norm_eps
    B, T, _ = x.shape
    H, K, Dh = spec.n_heads, spec.n_kv_heads, spec.head_dim
    d = x.shape[-1]
    src = x if xkv is None else xkv
    S = src.shape[1]
    q = (x @ fsdp(params["wq"]).reshape(d, H * Dh)).view(B, T, H, Dh)
    k = (src @ fsdp(params["wk"]).reshape(d, K * Dh)).view(B, S, K, Dh)
    v = (src @ fsdp(params["wv"]).reshape(d, K * Dh)).view(B, S, K, Dh)
    if constrain_dp:
        q = constrain(q, ("pod", "data"), None, None, None)
        k = constrain(k, ("pod", "data"), None, None, None)
        v = constrain(v, ("pod", "data"), None, None, None)
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"], 1e-6)
        k = rms_norm(k, params["k_norm"], 1e-6)
    if use_rope:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    window = 0 if is_global else spec.window

    if kv_cache is not None:
        ck, cv = kv_cache
        pos = 0 if cache_len is None else int(cache_len)
        _write_cache(ck, k, pos)
        _write_cache(cv, v, pos)
        if pos == 0:
            out = ops.gqa_flash_attention(q, ck[:, :T], cv[:, :T], causal=True,
                                          window=window, softcap=spec.softcap)
        else:
            out = attention(q, ck, cv, spec, q_offset=pos, is_global=is_global,
                            kv_len=pos + T)
        k_all, v_all = ck, cv
    elif xkv is not None:
        out = ops.gqa_flash_attention(q, k, v, causal=False,
                                      softcap=spec.softcap)
        k_all, v_all = k, v
    else:
        out = ops.gqa_flash_attention(q, k, v, causal=True, window=window,
                                      softcap=spec.softcap)
        k_all, v_all = k, v
    out = out.reshape(B, T, H * Dh) @ fsdp(params["wo"]).reshape(H * Dh, d)
    return out, (k_all, v_all)


# --- MLP -------------------------------------------------------------------------

def init_mlp_params(gen: torch.Generator, d_model: int, d_ff: int,
                    dtype: torch.dtype) -> Params:
    return {
        "wi_gate": dense_init(gen, d_model, (d_ff,), dtype),
        "wi_up": dense_init(gen, d_model, (d_ff,), dtype),
        "wo": dense_init(gen, d_ff, (d_model,), dtype),
    }


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


def mlp_block(params: Params, x: torch.Tensor, act: str,
              overlap: bool = False, constrain_dp: bool = False
              ) -> torch.Tensor:
    """(Sw/Ge)GLU FFN.

    With ``overlap`` (config.overlap == "shared_bus") under a mesh whose
    'model' dimension has size tp > 1 dividing both T and F, the two
    products run as Shared-PIM rings (``overlapped_ffn``) on each rank's
    sequence chunk and weight shards, the reference's rule; otherwise, and
    without a mesh, the plain path.  ``constrain_dp`` pins g and u to the
    batch axes.
    """
    if overlap:
        y = _overlapped_ffn(params, x, act)
        if y is not None:
            return y
    # pure DP with constrain_dp (the reference's pin on g and u);
    # otherwise, under a mesh, the hidden units over 'model' (eager DTensor
    # needs a layout here, for the products and their gradients: one it
    # picks for itself can shard the batch and the sequence together,
    # which the next matmul cannot take)
    hidden = None if constrain_dp else "model"

    def project(w):
        return constrain(x @ fsdp(w), ("pod", "data"), None, hidden)

    g = _act(project(params["wi_gate"]), act)
    u = project(params["wi_up"])
    return (g * u) @ fsdp(params["wo"])


def _overlapped_ffn(params: Params, x: torch.Tensor, act: str):
    """The FFN through ``collective_matmul.overlapped_ffn`` on this rank's
    shards, as a DTensor sequence-sharded over 'model'; None where the
    reference's rule leaves the plain path."""
    mesh = current_mesh()
    if mesh is None or isinstance(mesh, Mapping):
        return None
    tp = partition.axis_sizes(mesh).get("model", 1)
    F_ = params["wi_gate"].shape[-1]
    if not (tp > 1 and x.shape[1] % tp == 0 and F_ % tp == 0):
        return None
    from torch.distributed.tensor import DTensor

    from repro_torch.core.overlap.collective_matmul import overlapped_ffn

    bspec = partition.batch_spec(mesh, x.shape[0])
    seq = partition.to_placements(
        partition.spec(bspec[0] if bspec else None, "model", None), mesh)
    col = partition.to_placements(partition.spec(None, "model"), mesh)
    row = partition.to_placements(partition.spec("model", None), mesh)

    def local(t, placements, weight=False):
        t = _symbolic.to_layout(t, mesh, placements)
        if not weight:
            return t.to_local()
        # a weight replicated over the batch axes serves each rank's batch
        # shard: its gradient there is a partial sum
        from torch.distributed.tensor import Partial, Shard

        grad = [Partial() if isinstance(b, Shard) and b.dim == 0 else p
                for b, p in zip(seq, placements)]
        return t.to_local(grad_placements=grad)

    y = overlapped_ffn(local(x, seq), local(params["wi_gate"], col, True),
                       local(params["wi_up"], col, True),
                       local(params["wo"], row, True),
                       mesh, lambda v: _act(v, act))
    return DTensor.from_local(y, mesh, seq, run_check=False,
                              shape=x.shape, stride=x.stride())


# --- remat policies ---------------------------------------------------------------

# JAX's ``dots_with_no_batch_dims_saveable`` keeps the outputs of the
# projections (dot products without batch dims) and recomputes the rest; in
# the port those products dispatch as ``aten.mm`` / ``aten.addmm``.
# Attention (a batched product in the reference, the flash op here) is
# recomputed.
_SAVED_DOTS = frozenset({torch.ops.aten.mm.default,
                         torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    del ctx, args, kwargs
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_policy(name: str):
    """The ``context_fn`` of ``torch.utils.checkpoint`` for a policy name:
    None for "none" and "full" (plain checkpoint saves nothing), the
    selective contexts that save the projections for "dots"."""
    if name in ("none", "full"):
        return None
    if name == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _save_dots)
    raise ValueError(f"unknown remat policy {name!r}")


def maybe_remat(fn: Callable, policy_name: str) -> Callable:
    """``fn`` under activation checkpointing: "none" -> ``fn`` itself;
    "full" -> recompute everything in the backward; "dots" -> recompute
    everything but the projections' outputs."""
    context_fn = remat_policy(policy_name)
    if policy_name == "none":
        return fn
    kw = {} if context_fn is None else {"context_fn": context_fn}

    def wrapped(*args, **kwargs):
        mesh = current_mesh()
        if mesh is None:
            return checkpoint(fn, *args, use_reentrant=False, **kw, **kwargs)

        def under_mesh(*a, **k):
            # the recompute runs in the thread of the backward, which on a
            # card is the autograd engine's own, where the caller's mesh
            # (thread-local) is not set: without it the pins and the MoE
            # mesh path would be skipped there
            with use_mesh(mesh):
                return fn(*a, **k)

        # under a mesh the recompute runs collectives and ring hand-offs:
        # it must run to its end on every rank, or a hand-off it posts and
        # never waits on would pair with one of the backward's
        with set_checkpoint_early_stop(False):
            return checkpoint(under_mesh, *args, use_reentrant=False, **kw,
                              **kwargs)

    return wrapped
