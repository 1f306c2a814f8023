"""Model assembly, dense, MoE, VLM, audio, SSM and hybrid families (PyTorch
port of ``repro/models/model.py``).

``build(cfg, device)`` returns a ``Model`` with:

* ``init(gen)``                       -> params (stacked layers, leading L dim)
* ``forward(params, batch)``          -> logits (training / prefill path)
* ``init_cache(B, max_len)``          -> decode cache (K/V or conv/SSM
                                         state, and the position)
* ``prefill(params, cache, tokens, media)`` -> (last-position logits,
                                         cache at T, or T + n_media_tokens
                                         for audio)
* ``decode_step(params, cache, tok)`` -> (logits, cache)  [one-token serve step]
* ``train_loss(params, batch)``       -> mean next-token cross-entropy

The parameter tree is the reference's leaf for leaf (a dict with the layer
stack on a leading ``L`` dim), so a JAX parameter tree converts by a tree
map (``repro_torch.convert``).  The reference scans the layer stack; the
port runs a Python loop over it, and its per-layer local/global flag is a
Python bool.

The MoE family puts a ``moe`` sub-tree (``models/moe.py``) in place of each
layer's ``mlp``.  With ``moe_every > 1`` (llama4) the tree holds
``moe_every - 1`` dense layers for every MoE layer in ``blocks`` and the MoE
layers in ``moe_blocks``; they run a group at a time (the dense layers of a
group, then its MoE layer), and the decode cache holds the dense layers'
rows first, in run order, then the MoE layers' (the reference's
``_moe_grouped_pass``).

The audio family (musicgen) prefixes ``media @ media_proj`` (stub
conditioning frames) to the scaled token embeddings, runs without rope and
strips the prefix before the unembedding; its prefill caches the prefix's
K/V too.  The VLM family (llama-3.2-vision) follows every
``cross_attn_every`` self layers with a gated cross block, ``x +
tanh(gate) * attention(rms_norm(x))`` over ``media @ media_proj`` (stub
vision tokens), non-causal and without rope; a group is those self layers
and their cross block (the reference's ``_run_vlm``).  Prefill fills the
media K/V ``media_k`` / ``media_v`` once from every cross block's
``wk`` / ``wv``, and the cross blocks of prefill and decode attend over
them.  The SSM family runs Mamba-1 (falcon-mamba) or Mamba-2 layers by
``mamba_version``.  The hybrid family (zamba2) runs groups of
``attn_every`` Mamba layers, each followed by shared attention block
``g % n_shared_attn_blocks`` (attention and an MLP, its weights stacked in
``shared_attn``); its decode cache holds every layer's conv and SSM state
and one K/V row per application of a shared block, ``n_layers //
attn_every`` of them (the reference's ``_run_hybrid``/``_decode_hybrid``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.kernels import _symbolic, ops
from repro_torch.models import layers, moe, ssm
from repro_torch.models.layers import AttnSpec, Params
from repro_torch.sharding import partition
from repro_torch.sharding.context import constrain

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _stack_init(fn: Callable[[], Params], n: int) -> Params:
    """Call a per-layer init n times -> params stacked on a leading n dim.

    The stack is allocated once and filled layer by layer, so the peak is
    one layer above the stack (not two stacks, as ``torch.stack`` would)."""
    first = fn()
    out = tree.map_leaves(lambda a: a.new_empty((n, *a.shape)), first)

    def put(dst, src, i):
        for key, val in src.items():
            if isinstance(val, dict):
                put(dst[key], val, i)
            else:
                dst[key][i] = val

    put(out, first, 0)
    for i in range(1, n):
        put(out, fn(), i)
    return out


def _take(params: Params, i: int) -> Params:
    return tree.map_leaves(lambda a: a[i], params)


def _unstack(params: Params, n: int) -> list[Params]:
    """The n layers of a stacked tree, through one ``unbind`` a leaf: its
    backward stacks the n layer gradients once, where n ``a[i]`` selects
    would each add a zero-filled gradient of the whole stack."""
    parts = tree.map_leaves(lambda a: a.unbind(0), params)
    return [tree.map_leaves(lambda t: t[i], parts) for i in range(n)]


def _branch(a: torch.Tensor) -> torch.Tensor:
    """A residual branch's output (attention, MLP, MoE, Mamba mixer, cross
    block), pinned to the batch axes before it joins the residual stream,
    and its gradient pinned there too: the identity without a mesh.  Under
    one, eager DTensor would otherwise reduce-scatter a partial sum along
    the sequence, and the next projection would flatten a (batch x
    sequence)-sharded activation into a strided shard, which its matmul
    cannot take; a gradient in another layout makes the branch's backward
    gather its weights whole (the reference leaves these layouts to
    GSPMD)."""
    a = constrain(a, ("pod", "data"), None, None)
    return _GradLayout.apply(a) if _symbolic.is_dtensor(a) else a


class _GradLayout(torch.autograd.Function):
    """The identity on a DTensor whose backward puts the gradient on the
    input's placements (a partial sum's as replicated)."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate

        ctx.layout = (x.device_mesh, [p if not p.is_partial() else
                                      Replicate() for p in x.placements])
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        mesh, placements = ctx.layout
        if list(grad.placements) == placements:
            return grad
        return grad.redistribute(mesh, placements)


def _sharded_xent(lg: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logsumexp(lg) - lg[label] over a vocabulary sharded across ranks
    (DTensors), in ops whose backward stays on each rank's shard: the max
    and the sums reduce across ranks, and the gold logit is picked by a
    mask (a gather's backward would build the whole logit gradient)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    m = lg.detach().amax(dim=-1, keepdim=True)
    # each (B, T, V) term keeps lg's layout in the backward too (a sum's
    # gradient comes back replicated over the vocabulary, and DTensor
    # would gather the term to meet it)
    logz = torch.log(_GradLayout.apply(torch.exp(lg - m)).sum(dim=-1)) + \
        m[..., 0]
    # the vocabulary's ids sharded as lg's last dimension is, so the mask
    # and the pick stay on each rank's shard
    mesh, V = lg.device_mesh, lg.shape[-1]
    pl = [Shard(0) if isinstance(p, Shard) and p.dim == lg.dim() - 1
          else Replicate() for p in lg.placements]
    ids = partition.local_shard(torch.arange(V, device=lg.device), mesh, pl)
    vocab = DTensor.from_local(ids, mesh, pl, run_check=False, shape=(V,),
                               stride=(1,))
    gold = _GradLayout.apply(
        torch.where(vocab == labels[..., None], lg, 0.0)).sum(dim=-1)
    # pinned to the batch axes: the backward's (B, T) gradient then reaches
    # the (B, T, V) ops sharded, not as a replicated view whose reshard
    # would copy it whole
    return constrain(logz - gold, ("pod", "data"), None)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device

    # ---------------- parameter init ----------------

    def init(self, gen: torch.Generator) -> Params:
        """Random parameters, made on ``gen``'s device (the model's)."""
        cfg = self.cfg
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{self.device}")
        dtype = torch_dtype(cfg.dtype)
        dev = gen.device
        p: Params = {
            "embed": (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                                  device=dev, dtype=torch.float32)
                      * 0.02).to(dtype),
            "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        }
        if not cfg.tie_embeddings:
            p["unembed"] = layers.dense_init(gen, cfg.d_model,
                                             (cfg.vocab_size,), dtype)
        if cfg.family in ("ssm", "hybrid"):
            p["blocks"] = _stack_init(lambda: self._init_ssm_block(gen, dtype),
                                      cfg.n_layers)
        elif cfg.family == "moe" and cfg.moe_every > 1:
            n_moe = cfg.n_layers // cfg.moe_every
            p["blocks"] = _stack_init(
                lambda: self._init_block(gen, dtype, kind="dense"),
                cfg.n_layers - n_moe)
            p["moe_blocks"] = _stack_init(
                lambda: self._init_block(gen, dtype, kind="moe"), n_moe)
        else:
            p["blocks"] = _stack_init(lambda: self._init_block(gen, dtype),
                                      cfg.n_layers)
        if cfg.family == "hybrid":
            p["shared_attn"] = _stack_init(
                lambda: self._init_shared_attn(gen, dtype),
                cfg.n_shared_attn_blocks)
        if cfg.family == "vlm":
            p["cross_blocks"] = _stack_init(
                lambda: self._init_cross_block(gen, dtype), self._n_cross())
        if cfg.family in ("vlm", "audio"):
            p["media_proj"] = layers.dense_init(gen, cfg.media_embed_dim,
                                                (cfg.d_model,), dtype)
        return p

    def _n_cross(self) -> int:
        return self.cfg.n_layers // self.cfg.cross_attn_every

    def param_dtypes(self) -> Params:
        """The dtype of every leaf that ``init`` makes, as a tree: the
        reduced config's init on the CPU (``reduced()`` keeps the family and
        its flags, so the tree and the dtypes are the same)."""
        small = Model(self.cfg.reduced(), torch.device("cpu"))
        return tree.map_leaves(lambda a: a.dtype,
                        small.init(torch.Generator().manual_seed(0)))

    def _attn_spec(self) -> AttnSpec:
        cfg = self.cfg
        return AttnSpec(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                        window=cfg.sliding_window,
                        softcap=cfg.attn_logit_softcap)

    def _init_block(self, gen: torch.Generator, dtype: torch.dtype,
                    kind: str | None = None) -> Params:
        """A decoder layer; ``kind`` "moe" (the MoE family's default) puts
        a ``moe`` sub-tree in place of the ``mlp``."""
        cfg = self.cfg
        dev = gen.device
        if kind is None:
            kind = "moe" if cfg.family == "moe" else "dense"
        p = {
            "ln1": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
            "attn": layers.init_attn_params(gen, cfg.d_model,
                                            self._attn_spec(), dtype,
                                            qk_norm=cfg.qk_norm),
            "ln2": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        }
        if kind == "moe":
            p["moe"] = moe.init_moe_params(gen, cfg.d_model, cfg, dtype)
        else:
            p["mlp"] = layers.init_mlp_params(gen, cfg.d_model, cfg.d_ff,
                                              dtype)
        return p

    def _init_cross_block(self, gen: torch.Generator, dtype: torch.dtype
                          ) -> Params:
        """A VLM cross block; its ``gate`` is a float32 scalar, 0 at init
        (so the block adds nothing until trained), whatever ``dtype``."""
        cfg = self.cfg
        dev = gen.device
        return {"ln": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
                "attn": layers.init_attn_params(gen, cfg.d_model,
                                                self._attn_spec(), dtype),
                "gate": torch.zeros((), dtype=torch.float32, device=dev)}

    def _init_shared_attn(self, gen: torch.Generator, dtype: torch.dtype
                          ) -> Params:
        """A zamba2 shared block: attention and an MLP (the Mamba layers
        carry no MLP)."""
        cfg = self.cfg
        dev = gen.device
        return {"ln": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
                "attn": layers.init_attn_params(gen, cfg.d_model,
                                                self._attn_spec(), dtype),
                "ln2": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
                "mlp": layers.init_mlp_params(gen, cfg.d_model, cfg.d_ff,
                                              dtype)}

    def _init_ssm_block(self, gen: torch.Generator, dtype: torch.dtype
                        ) -> Params:
        cfg = self.cfg
        return {"ln": torch.zeros((cfg.d_model,), dtype=dtype,
                                  device=gen.device),
                "mixer": ssm.init_mamba_params(gen, cfg, dtype)}

    # ---------------- per-layer flags ----------------

    def _layer_is_global(self) -> list[bool]:
        cfg = self.cfg
        if cfg.sliding_window and cfg.local_global_every:
            every = cfg.local_global_every
            return [i % every == every - 1 for i in range(cfg.n_layers)]
        return [True] * cfg.n_layers

    # ---------------- forward (train / prefill) ----------------

    def _embed_tokens(self, params: Params, tokens: torch.Tensor
                      ) -> torch.Tensor:
        cfg = self.cfg
        x = layers.embed_lookup(params["embed"], tokens)
        if cfg.family == "dense" and cfg.tie_embeddings or \
                cfg.family == "audio":
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
        return x

    def _media_tokens(self, params: Params, media: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
        """(B, n_media_tokens, media_embed_dim) stub frontend output ->
        (B, n_media_tokens, d_model) in the model dtype."""
        return media.to(dtype) @ layers.fsdp(params["media_proj"])

    def embed_inputs(self, params: Params, batch: dict) -> torch.Tensor:
        """Token embeddings (scaled by sqrt(d) for tied dense and audio);
        for audio, prefixed with the projected ``batch["media"]``."""
        x = self._embed_tokens(params, batch["tokens"])
        if self.cfg.family == "audio":
            media = self._media_tokens(params, batch["media"], x.dtype)
            x = torch.cat([media, x], dim=1)
        return x

    def forward(self, params: Params, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        x = self.embed_inputs(params, batch)
        B, T, _ = x.shape
        positions = torch.arange(T, device=x.device)[None, :].expand(B, T)
        if cfg.family == "ssm":
            x = self._run_ssm(params, x)
        elif cfg.family == "hybrid":
            x = self._run_hybrid(params, x, positions)
        else:
            mtok = (self._media_tokens(params, batch["media"], x.dtype)
                    if cfg.family == "vlm" else None)
            x = self._run_decoder(params, x, positions, mtok=mtok)
        x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
        if cfg.family == "audio":
            x = x[:, cfg.n_media_tokens:]          # strip the conditioning
        return self._unembed(params, x)

    def _unembed(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        logits = x @ layers.fsdp(w).to(x.dtype)
        if cfg.final_logit_softcap:
            logits = (cfg.final_logit_softcap
                      * torch.tanh(logits / cfg.final_logit_softcap))
        return logits

    def _constrain_residual(self, x):
        """With ``cfg.constrain_activations``, pin the residual stream to
        the batch axes at layer boundaries (the identity without a
        mesh)."""
        if not self.cfg.constrain_activations:
            return x
        return constrain(x, ("pod", "data"), None, None)

    def _decoder_layer(self, blk: Params, x, positions, is_global: bool,
                       kv_cache=None, cache_len=None):
        cfg = self.cfg
        x = self._constrain_residual(x)
        h = layers.rms_norm(x, blk["ln1"], cfg.norm_eps)
        a, kv = layers.attn_block(
            blk["attn"], h, self._attn_spec(), rope_theta=cfg.rope_theta,
            norm_eps=cfg.norm_eps, positions=positions, is_global=is_global,
            kv_cache=kv_cache, cache_len=cache_len,
            use_rope=cfg.family != "audio",
            constrain_dp=cfg.constrain_internals)
        x = x + _branch(a)
        h = layers.rms_norm(x, blk["ln2"], cfg.norm_eps)
        if "moe" in blk:
            x = x + _branch(moe.moe_block(blk["moe"], h, cfg))
        else:
            x = x + _branch(layers.mlp_block(
                blk["mlp"], h, cfg.act, overlap=cfg.overlap == "shared_bus",
                constrain_dp=cfg.constrain_internals))
        return x, kv

    def _cross_layer(self, blk: Params, x, mtok=None, media_kv=None):
        """The gated cross block: ``x + tanh(gate) * a``, ``a`` the
        non-causal attention of ``rms_norm(x)`` over the media tokens,
        without rope: over ``mtok``'s keys and values (forward), or over the
        cached ``media_kv`` = (media_k, media_v), (B, M, K, Dh) each (prefill
        and decode)."""
        cfg = self.cfg
        spec = self._attn_spec()
        h = layers.rms_norm(x, blk["ln"], cfg.norm_eps)
        if media_kv is None:
            a, _ = layers.attn_block(
                blk["attn"], h, spec, rope_theta=cfg.rope_theta,
                norm_eps=cfg.norm_eps, positions=None, xkv=mtok,
                use_rope=False)
        else:
            B, T, d = h.shape
            H, Dh = spec.n_heads, spec.head_dim
            q = (h @ layers.fsdp(blk["attn"]["wq"]).reshape(d, H * Dh)).view(B, T, H, Dh)
            out = ops.gqa_flash_attention(q, *media_kv, causal=False,
                                          softcap=spec.softcap)
            a = out.reshape(B, T, H * Dh) @ layers.fsdp(blk["attn"]["wo"]).reshape(
                H * Dh, d)
        return x + torch.tanh(blk["gate"]).to(x.dtype) * _branch(a)

    def _layer_groups(self, params, grad: bool) -> list[list[tuple]]:
        """The decoder layers in run order, as groups of (layer params,
        is_global, cache row): one layer a group; with ``moe_blocks`` the
        ``moe_every - 1`` dense layers and then the MoE layer of each
        group, every layer global, the dense layers' cache rows first;
        with ``cross_blocks`` (VLM) ``cross_attn_every`` self layers and
        then the group's cross block, whose row is its media K/V row.
        Under ``grad`` the stacks are split by ``_unstack``."""
        cfg = self.cfg

        def split(name, n):
            if grad:
                return _unstack(params[name], n)
            return [_take(params[name], i) for i in range(n)]

        if "moe_blocks" in params:
            k = cfg.moe_every - 1
            n_groups = cfg.n_layers // cfg.moe_every
            n_dense = n_groups * k
            dense = split("blocks", n_dense)
            moes = split("moe_blocks", n_groups)
            return [[(dense[g * k + j], True, g * k + j) for j in range(k)]
                    + [(moes[g], True, n_dense + g)] for g in range(n_groups)]
        blocks = split("blocks", cfg.n_layers)
        flags = self._layer_is_global()
        if "cross_blocks" in params:
            k = cfg.cross_attn_every
            cross = split("cross_blocks", self._n_cross())
            return [[(blocks[i], flags[i], i) for i in range(g * k, g * k + k)]
                    + [(cb, True, g)] for g, cb in enumerate(cross)]
        return [[(blk, is_global, i)] for i, (blk, is_global) in
                enumerate(zip(blocks, flags))]

    def _run_decoder(self, params, x, positions, cache=None, cache_len=None,
                     mtok=None):
        """All layers over x; with a cache, each layer reads and writes its
        K/V rows ``cache["k"][row]``, ``cache["v"][row]`` in place, and a
        VLM cross block reads ``cache["media_k"][row]``, ``["media_v"]``
        (without a cache it attends over ``mtok``).  Under grad mode, when
        anything requires grad, each group of ``_layer_groups`` runs under
        ``maybe_remat(cfg.remat_policy)``, as the reference's scanned layer
        or group does."""
        def layer(blk, x, is_global, row, mtok):
            if "gate" in blk:
                media_kv = (None if cache is None else
                            (cache["media_k"][row], cache["media_v"][row]))
                return self._cross_layer(blk, x, mtok, media_kv)
            kv = None if cache is None else (cache["k"][row], cache["v"][row])
            return self._decoder_layer(blk, x, positions, is_global,
                                       kv_cache=kv, cache_len=cache_len)[0]

        if self._training(params, x, cache):
            def group(blks, x, flags, mtok):
                for blk, is_global in zip(blks, flags):
                    x = layer(blk, x, is_global, None, mtok)
                return x

            group = layers.maybe_remat(group, self.cfg.remat_policy)
            for grp in self._layer_groups(params, grad=True):
                x = group([blk for blk, _, _ in grp], x,
                          [is_global for _, is_global, _ in grp], mtok)
            return x
        for grp in self._layer_groups(params, grad=False):
            for blk, is_global, row in grp:
                x = layer(blk, x, is_global, row, mtok)
        return x

    @staticmethod
    def _training(params, x, cache) -> bool:
        """No cache, grad mode on and something requiring grad: the layers
        then run as the reference's ``jax.grad`` sees them, the stacks split
        by ``_unstack`` and each layer or group under ``maybe_remat``."""
        return cache is None and torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad
                                   for p in tree.leaves(params)))

    def _ssm_layer(self, blk: Params, x, state=None):
        cfg = self.cfg
        mixer = ssm.mamba1_block if cfg.mamba_version == 1 else \
            ssm.mamba2_block
        x = self._constrain_residual(x)
        h = layers.rms_norm(x, blk["ln"], cfg.norm_eps)
        y, new_state = mixer(blk["mixer"], h, cfg, state=state)
        return x + _branch(y), new_state

    def _run_ssm(self, params, x, cache=None, indices=None):
        """Mamba layers ``indices`` (default all) over x; with a cache,
        layer i starts from ``cache["conv"][i]``, ``cache["h"][i]`` and
        writes its new state there in place.  In training each layer runs
        under ``maybe_remat`` (the reference's ``_run_ssm``)."""
        idx = range(self.cfg.n_layers) if indices is None else indices
        if self._training(params, x, cache):
            blocks = _unstack(params["blocks"], self.cfg.n_layers)
            layer = layers.maybe_remat(
                lambda blk, x: self._ssm_layer(blk, x)[0],
                self.cfg.remat_policy)
            for i in idx:
                x = layer(blocks[i], x)
            return x
        for i in idx:
            st = None if cache is None else (cache["conv"][i], cache["h"][i])
            x, (conv, h) = self._ssm_layer(_take(params["blocks"], i), x, st)
            if cache is not None:
                cache["conv"][i].copy_(conv)
                cache["h"][i].copy_(h)
        return x

    def _shared_attn_layer(self, sa: Params, x, positions, kv_cache=None,
                           cache_len=None):
        """A zamba2 shared block: ``x + attention(rms_norm(x))``, then
        ``x + mlp(rms_norm(x))``; global, causal, with rope."""
        cfg = self.cfg
        h = layers.rms_norm(x, sa["ln"], cfg.norm_eps)
        a, _ = layers.attn_block(
            sa["attn"], h, self._attn_spec(), rope_theta=cfg.rope_theta,
            norm_eps=cfg.norm_eps, positions=positions, kv_cache=kv_cache,
            cache_len=cache_len)
        x = x + _branch(a)
        h = layers.rms_norm(x, sa["ln2"], cfg.norm_eps)
        return x + _branch(layers.mlp_block(
            sa["mlp"], h, cfg.act, overlap=cfg.overlap == "shared_bus"))

    def _run_hybrid(self, params, x, positions, cache=None, cache_len=None):
        """Group g runs Mamba layers g*k .. g*k+k-1 (k = ``attn_every``),
        then shared block ``g % n_shared_attn_blocks``; with a cache the
        layers read and write their state as in ``_run_ssm`` and the shared
        block of group g its K/V row ``cache["k"][g]``, ``cache["v"][g]``,
        in place.  In training each group (its Mamba layers and its shared
        block) runs under ``maybe_remat``, as the reference's scanned
        group."""
        cfg = self.cfg
        k = cfg.attn_every
        if self._training(params, x, cache):
            blocks = _unstack(params["blocks"], cfg.n_layers)
            shared = _unstack(params["shared_attn"], cfg.n_shared_attn_blocks)

            def group(blks, sa, x):
                for blk in blks:
                    x = self._ssm_layer(blk, x)[0]
                return self._shared_attn_layer(sa, x, positions)

            group = layers.maybe_remat(group, cfg.remat_policy)
            for g in range(cfg.n_layers // k):
                x = group(blocks[g * k:g * k + k],
                          shared[g % cfg.n_shared_attn_blocks], x)
            return x
        for g in range(cfg.n_layers // k):
            x = self._run_ssm(params, x, cache, range(g * k, g * k + k))
            sa = _take(params["shared_attn"], g % cfg.n_shared_attn_blocks)
            kv = None if cache is None else (cache["k"][g], cache["v"][g])
            x = self._shared_attn_layer(sa, x, positions, kv, cache_len)
        return x

    # ---------------- loss ----------------

    def train_loss(self, params: Params, batch: dict) -> torch.Tensor:
        """Mean next-token cross-entropy over B x (T - 1), from float32
        logits, pinned to (batch, -, 'model') before and after the cast so
        the vocabulary stays sharded (the identity without a mesh)."""
        logits = self.forward(params, batch)
        logits = constrain(logits, ("pod", "data"), None, "model")
        if _symbolic.is_dtensor(logits):
            # every position's loss against the next token (the last one's
            # against a wrapped label) and the last dropped: a slice of the
            # (B, T, V) logits would gather the vocabulary in its backward
            tokens = batch["tokens"].long()
            labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
            lg = constrain(logits.float(), ("pod", "data"), None, "model")
            return torch.mean(_sharded_xent(lg, labels)[:, :-1])
        labels = batch["tokens"][:, 1:].long()
        lg = constrain(logits[:, :-1].float(), ("pod", "data"), None,
                       "model")
        logz = torch.logsumexp(lg, dim=-1)
        gold = torch.take_along_dim(lg, labels[..., None], dim=-1)[..., 0]
        return torch.mean(logz - gold)

    # ---------------- prefill ----------------

    @torch.no_grad()
    def prefill(self, params: Params, cache: dict, tokens: torch.Tensor,
                media: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, dict]:
        """Fill the decode cache from a (B, T) prompt (and, for the VLM and
        audio families, the (B, n_media_tokens, media_embed_dim) ``media``);
        returns last-position logits and the cache positioned after the
        prompt: at T, or T + n_media_tokens for audio, whose conditioning
        frames are cached as the prompt's first positions.  The cache's
        tensors (K/V, media K/V, or conv and SSM state) are written in
        place."""
        cfg = self.cfg
        batch = {"tokens": tokens}
        if media is not None:
            batch["media"] = media
        x = self.embed_inputs(params, batch)
        B, T, _ = x.shape
        positions = torch.arange(T, device=x.device)[None, :].expand(B, T)
        if cfg.family == "ssm":
            x = self._run_ssm(params, x, cache=cache)
        elif cfg.family == "hybrid":
            x = self._run_hybrid(params, x, positions, cache=cache,
                                 cache_len=0)
        else:
            if cfg.family == "vlm":
                self._fill_media_kv(params, cache, batch["media"], x.dtype)
            x = self._run_decoder(params, x, positions, cache=cache,
                                  cache_len=0)
        x = layers.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
        return self._unembed(params, x), {**cache, "pos": T}

    def _fill_media_kv(self, params: Params, cache: dict,
                       media: torch.Tensor, dtype: torch.dtype) -> None:
        """``cache["media_k"][g]``, ``["media_v"][g]`` = the projected media
        tokens through cross block g's ``wk``, ``wv``, written in place."""
        mtok = self._media_tokens(params, media, dtype)
        B, M, d = mtok.shape
        K, Dh = self.cfg.n_kv_heads, self.cfg.head_dim
        attn = params["cross_blocks"]["attn"]
        for g in range(self._n_cross()):
            for name, w in (("media_k", attn["wk"][g]),
                            ("media_v", attn["wv"][g])):
                cache[name][g].copy_(
                    (mtok @ layers.fsdp(w).reshape(d, K * Dh)).view(B, M, K, Dh))

    # ---------------- decode ----------------

    def init_cache(self, batch_size: int, max_len: int) -> dict:
        """The shared position ``pos`` (a Python int) and, for attention,
        K/V ``(L, B, max_len, K, Dh)`` in the model dtype; for Mamba,
        ``conv`` ``(L, B, ssm_conv - 1, d_inner)`` in the model dtype and
        ``h`` in float32, whatever ``max_len``: ``(L, B, d_inner,
        ssm_state)`` for Mamba-1, ``(L, B, H, ssm_head_dim, ssm_state)``
        for Mamba-2; for the hybrid also K/V ``(n_layers // attn_every, B,
        max_len, K, Dh)``, one row per application of a shared block; for
        the VLM also ``media_k`` / ``media_v`` ``(n_cross, B,
        n_media_tokens, K, Dh)`` in the model dtype."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        L, dev = cfg.n_layers, self.device
        cache: dict = {"pos": 0}
        if cfg.family in ("ssm", "hybrid"):
            di, n = cfg.d_inner, cfg.ssm_state
            hshape = ((di, n) if cfg.mamba_version == 1 else
                      (di // cfg.ssm_head_dim, cfg.ssm_head_dim, n))
            cache["conv"] = torch.zeros((L, batch_size, cfg.ssm_conv - 1, di),
                                        dtype=dtype, device=dev)
            cache["h"] = torch.zeros((L, batch_size, *hshape),
                                     dtype=torch.float32, device=dev)
            if cfg.family == "ssm":
                return cache
            L = cfg.n_layers // cfg.attn_every
        shape = (L, batch_size, max_len, cfg.n_kv_heads, cfg.head_dim)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=dev)
        if cfg.family == "vlm":
            shape = (self._n_cross(), batch_size, cfg.n_media_tokens,
                     cfg.n_kv_heads, cfg.head_dim)
            cache["media_k"] = torch.zeros(shape, dtype=dtype, device=dev)
            cache["media_v"] = torch.zeros(shape, dtype=dtype, device=dev)
        return cache

    @torch.no_grad()
    def decode_step(self, params: Params, cache: dict, tokens: torch.Tensor,
                    media: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, dict]:
        """One serve step: tokens (B, 1) -> logits (B, 1, V), updated cache.
        ``media`` is accepted and unused, as in the reference: the VLM's
        cross blocks read the media K/V that prefill cached, and audio's
        conditioning is in the K/V cache."""
        del media
        cfg = self.cfg
        x = self._embed_tokens(params, tokens)
        pos = int(cache["pos"])
        positions = torch.full((tokens.shape[0], 1), pos, dtype=torch.long,
                               device=x.device)
        if cfg.family == "ssm":
            x = self._run_ssm(params, x, cache=cache)
        elif cfg.family == "hybrid":
            x = self._run_hybrid(params, x, positions, cache=cache,
                                 cache_len=pos)
        else:
            x = self._run_decoder(params, x, positions, cache=cache,
                                  cache_len=pos)
        x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._unembed(params, x), {**cache, "pos": pos + 1}


def build(cfg: ModelConfig, device: str | torch.device = "cuda") -> Model:
    if cfg.family == "hybrid" and (cfg.attn_every <= 0 or
                                   cfg.n_layers % cfg.attn_every):
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                         f"multiple of attn_every {cfg.attn_every}")
    return Model(cfg, resolve(device))
