"""Architecture registry: ``get("glm4-9b")`` -> ModelConfig.

The port covers every arch of the reference registry: the dense, MoE, VLM,
audio and SSM families and the Mamba-2 hybrid (zamba2).
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "gemma3-1b": "gemma3_1b",
    "granite-3-2b": "granite_3_2b",
    "gemma2-9b": "gemma2_9b",
    "glm4-9b": "glm4_9b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "musicgen-medium": "musicgen_medium",
    "zamba2-2.7b": "zamba2_2_7b",
}

ARCHS = tuple(_MODULES)


def get(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
