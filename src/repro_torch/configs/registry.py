"""Architecture registry: ``get("glm4-9b")`` -> ModelConfig.

The port covers the dense and MoE families and the Mamba-1 member of the
SSM family.  The other three archs of the reference registry (Mamba-2
hybrid, VLM, audio) are known by name and raise ``NotImplementedError``
naming the ROADMAP item (Queue 1) that will add them.
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
}

_NOT_PORTED = {
    "zamba2-2.7b": "ROADMAP Queue 1 item 7b (models/ssm.py, Mamba-2 hybrid)",
    "llama-3.2-vision-11b": "ROADMAP Queue 1 item 8 (VLM cross blocks)",
    "musicgen-medium": "ROADMAP Queue 1 item 8 (audio family)",
}

ARCHS = tuple(_MODULES)
ALL_ARCHS = ARCHS + tuple(_NOT_PORTED)


def get(name: str) -> ModelConfig:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet; see {_NOT_PORTED[name]}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ALL_ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
