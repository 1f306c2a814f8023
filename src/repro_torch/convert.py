"""Parameter transfer from the JAX reference package.

``params_from_numpy`` takes the reference's parameter tree as nested dicts
of numpy arrays (the caller converts, e.g.
``jax.tree.map(lambda a: np.asarray(a, np.float32), params)``) and returns
the port's tree, leaf for leaf, as tensors in ``cfg.dtype``.  bfloat16
leaves arrive as float32 numpy, and casting them back is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models.model import torch_dtype, tree_map


def params_from_numpy(tree: dict, cfg: ModelConfig,
                      device: str | torch.device = "cuda") -> dict:
    dev = resolve(device)
    dtype = torch_dtype(cfg.dtype)

    def leaf(a):
        a = np.asarray(a)
        if not np.issubdtype(a.dtype, np.floating):
            raise TypeError(f"non-float parameter leaf of dtype {a.dtype}")
        return torch.from_numpy(np.array(a)).to(device=dev, dtype=dtype)

    return tree_map(leaf, tree)
