"""Fake-tensor stand-ins for every model input per (arch, shape) cell
(PyTorch port of ``repro/launch/specs.py``).

The reference's ``ShapeDtypeStruct``s become fake tensors: shaped and
typed, on the requested device, with no storage, so a full-size cell costs
nothing to build.  They are made under the ``FakeTensorMode`` the caller
has entered (the dry-run's), or under a new one.  For decode shapes the
cache represents a FULL KV/SSM cache of ``seq_len`` (the cell's defining
workload: one new token against a seq_len cache).  The cache's ``pos`` is
the port's Python int where the reference has an int32 scalar.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.model import Model


def _mode():
    """The active ``FakeTensorMode``'s context (already entered: nothing
    to do), or a new one's."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    if detect_fake_mode() is not None:
        return contextlib.nullcontext()
    return FakeTensorMode()


def sds(shape, dtype, device) -> torch.Tensor:
    with _mode():
        return torch.empty(tuple(shape), dtype=dtype, device=device)


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                      device: str = "cuda") -> dict:
    B, T = shape.global_batch, shape.seq_len
    out = {"tokens": sds((B, T), torch.int32, device)}
    if cfg.n_media_tokens:
        out["media"] = sds((B, cfg.n_media_tokens, cfg.media_embed_dim),
                           torch.float32, device)
    return out


def cache_specs(model: Model, batch: int, max_len: int) -> dict:
    """``init_cache`` on fake tensors, on the model's device."""
    with _mode():
        return model.init_cache(batch, max_len)


def _media(cfg: ModelConfig, B: int, device):
    return (sds((B, cfg.n_media_tokens, cfg.media_embed_dim), torch.float32,
                device) if cfg.n_media_tokens else None)


def decode_input_specs(cfg: ModelConfig, model: Model, shape: ShapeConfig
                       ) -> tuple[dict, dict]:
    B = shape.global_batch
    cache = cache_specs(model, B, shape.seq_len)
    tokens = sds((B, 1), torch.int32, model.device)
    return cache, {"tokens": tokens, "media": _media(cfg, B, model.device)}


def prefill_input_specs(cfg: ModelConfig, model: Model, shape: ShapeConfig
                        ) -> tuple[dict, dict]:
    B, T = shape.global_batch, shape.seq_len
    cache_len = T + (cfg.n_media_tokens if cfg.family == "audio" else 0)
    cache = cache_specs(model, B, cache_len)
    tokens = sds((B, T), torch.int32, model.device)
    return cache, {"tokens": tokens, "media": _media(cfg, B, model.device)}
