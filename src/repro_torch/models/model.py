"""Model assembly, dense and SSM families (PyTorch port of
``repro/models/model.py``).

``build(cfg, device)`` returns a ``Model`` with:

* ``init(gen)``                       -> params (stacked layers, leading L dim)
* ``forward(params, batch)``          -> logits (training / prefill path)
* ``init_cache(B, max_len)``          -> decode cache (K/V or conv/SSM
                                         state, and the position)
* ``prefill(params, cache, tokens)``  -> (last-position logits, cache at T)
* ``decode_step(params, cache, tok)`` -> (logits, cache)  [one-token serve step]
* ``train_loss(params, batch)``       -> mean next-token cross-entropy

The parameter tree is the reference's leaf for leaf (a dict with the layer
stack on a leading ``L`` dim), so a JAX parameter tree converts by a tree
map (``repro_torch.convert``).  The reference scans the layer stack; the
port runs a Python loop over it, and its per-layer local/global flag is a
Python bool.  The SSM family covers Mamba-1 (falcon-mamba); the other
families (MoE, Mamba-2 hybrid, VLM, audio) are not ported yet and raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import layers, ssm
from repro_torch.models.layers import AttnSpec, Params

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
        init_block = (self._init_ssm_block if cfg.family == "ssm"
                      else self._init_block)
        p["blocks"] = _stack_init(lambda: init_block(gen, dtype),
                                  cfg.n_layers)
        return p

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

    def _init_block(self, gen: torch.Generator, dtype: torch.dtype) -> Params:
        cfg = self.cfg
        dev = gen.device
        return {
            "ln1": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
            "attn": layers.init_attn_params(gen, cfg.d_model,
                                            self._attn_spec(), dtype,
                                            qk_norm=cfg.qk_norm),
            "ln2": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
            "mlp": layers.init_mlp_params(gen, cfg.d_model, cfg.d_ff, dtype),
        }

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

    def embed_inputs(self, params: Params, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        x = params["embed"][batch["tokens"]]
        # the reference's `dense and tied or audio`, for the ported families
        if cfg.family == "dense" and cfg.tie_embeddings:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
        return x

    def forward(self, params: Params, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        x = self.embed_inputs(params, batch)
        B, T, _ = x.shape
        if cfg.family == "ssm":
            x = self._run_ssm(params, x)
        else:
            positions = torch.arange(T, device=x.device)[None, :].expand(B, T)
            x = self._run_decoder(params, x, positions)
        x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._unembed(params, x)

    def _unembed(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        logits = x @ w.to(x.dtype)
        if cfg.final_logit_softcap:
            logits = (cfg.final_logit_softcap
                      * torch.tanh(logits / cfg.final_logit_softcap))
        return logits

    def _decoder_layer(self, blk: Params, x, positions, is_global: bool,
                       kv_cache=None, cache_len=None):
        cfg = self.cfg
        h = layers.rms_norm(x, blk["ln1"], cfg.norm_eps)
        a, kv = layers.attn_block(
            blk["attn"], h, self._attn_spec(), rope_theta=cfg.rope_theta,
            norm_eps=cfg.norm_eps, positions=positions, is_global=is_global,
            kv_cache=kv_cache, cache_len=cache_len)
        x = x + a
        h = layers.rms_norm(x, blk["ln2"], cfg.norm_eps)
        x = x + layers.mlp_block(blk["mlp"], h, cfg.act)
        return x, kv

    def _run_decoder(self, params, x, positions, cache=None, cache_len=None):
        """All layers over x; with a cache, layer i reads and writes its
        K/V rows ``cache["k"][i]``, ``cache["v"][i]`` in place.  Under grad
        mode each layer runs under ``maybe_remat(cfg.remat_policy)``, as the
        reference's scanned layer does, when anything requires grad."""
        if cache is None and torch.is_grad_enabled() and (
                x.requires_grad or any(
                    p.requires_grad for p in tree.leaves(params["blocks"]))):
            def layer(blk, x, is_global):
                return self._decoder_layer(blk, x, positions, is_global)[0]

            layer = layers.maybe_remat(layer, self.cfg.remat_policy)
            blocks = _unstack(params["blocks"], self.cfg.n_layers)
            for blk, is_global in zip(blocks, self._layer_is_global()):
                x = layer(blk, x, is_global)
            return x
        for i, is_global in enumerate(self._layer_is_global()):
            kv = None if cache is None else (cache["k"][i], cache["v"][i])
            x, _ = self._decoder_layer(_take(params["blocks"], i), x,
                                       positions, is_global, kv_cache=kv,
                                       cache_len=cache_len)
        return x

    def _ssm_layer(self, blk: Params, x, state=None):
        cfg = self.cfg
        h = layers.rms_norm(x, blk["ln"], cfg.norm_eps)
        y, new_state = ssm.mamba1_block(blk["mixer"], h, cfg, state=state)
        return x + y, new_state

    def _run_ssm(self, params, x, cache=None):
        """All Mamba layers over x; with a cache, layer i starts from
        ``cache["conv"][i]``, ``cache["h"][i]`` and writes its new state
        there in place."""
        for i in range(self.cfg.n_layers):
            st = None if cache is None else (cache["conv"][i], cache["h"][i])
            x, (conv, h) = self._ssm_layer(_take(params["blocks"], i), x, st)
            if cache is not None:
                cache["conv"][i].copy_(conv)
                cache["h"][i].copy_(h)
        return x

    # ---------------- loss ----------------

    def train_loss(self, params: Params, batch: dict) -> torch.Tensor:
        """Mean next-token cross-entropy over B x (T - 1), from float32
        logits (the reference's sharding pins are no-ops on one card)."""
        logits = self.forward(params, batch)
        labels = batch["tokens"][:, 1:].long()
        lg = logits[:, :-1].float()
        logz = torch.logsumexp(lg, dim=-1)
        gold = torch.take_along_dim(lg, labels[..., None], dim=-1)[..., 0]
        return torch.mean(logz - gold)

    # ---------------- prefill ----------------

    @torch.no_grad()
    def prefill(self, params: Params, cache: dict, tokens: torch.Tensor
                ) -> tuple[torch.Tensor, dict]:
        """Fill the decode cache from a (B, T) prompt; returns last-position
        logits and the cache positioned at T.  The cache's tensors (K/V, or
        conv and SSM state) are written in place."""
        cfg = self.cfg
        x = self.embed_inputs(params, {"tokens": tokens})
        B, T, _ = x.shape
        if cfg.family == "ssm":
            x = self._run_ssm(params, x, cache=cache)
        else:
            positions = torch.arange(T, device=x.device)[None, :].expand(B, T)
            x = self._run_decoder(params, x, positions, cache=cache,
                                  cache_len=0)
        x = layers.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
        return self._unembed(params, x), {**cache, "pos": T}

    # ---------------- decode ----------------

    def init_cache(self, batch_size: int, max_len: int) -> dict:
        """The shared position ``pos`` (a Python int) and, for attention,
        K/V ``(L, B, max_len, K, Dh)`` in the model dtype; for Mamba-1,
        ``conv`` ``(L, B, ssm_conv - 1, d_inner)`` in the model dtype and
        ``h`` ``(L, B, d_inner, ssm_state)`` in float32, whatever
        ``max_len``."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        L, dev = cfg.n_layers, self.device
        if cfg.family == "ssm":
            di = cfg.d_inner
            return {"pos": 0,
                    "conv": torch.zeros((L, batch_size, cfg.ssm_conv - 1, di),
                                        dtype=dtype, device=dev),
                    "h": torch.zeros((L, batch_size, di, cfg.ssm_state),
                                     dtype=torch.float32, device=dev)}
        shape = (L, batch_size, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {"pos": 0,
                "k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device)}

    @torch.no_grad()
    def decode_step(self, params: Params, cache: dict, tokens: torch.Tensor
                    ) -> tuple[torch.Tensor, dict]:
        """One serve step: tokens (B, 1) -> logits (B, 1, V), updated cache."""
        cfg = self.cfg
        x = self.embed_inputs(params, {"tokens": tokens})
        pos = int(cache["pos"])
        if cfg.family == "ssm":
            x = self._run_ssm(params, x, cache=cache)
        else:
            positions = torch.full((tokens.shape[0], 1), pos,
                                   dtype=torch.long, device=x.device)
            x = self._run_decoder(params, x, positions, cache=cache,
                                  cache_len=pos)
        x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._unembed(params, x), {**cache, "pos": pos + 1}


def build(cfg: ModelConfig, device: str | torch.device = "cuda") -> Model:
    if not (cfg.family == "dense" or
            cfg.family == "ssm" and cfg.mamba_version == 1):
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; the port "
            "covers the dense family and Mamba-1 (see ROADMAP.md Queue 1)")
    return Model(cfg, resolve(device))
