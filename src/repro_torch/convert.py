"""Parameter transfer from the JAX reference package.

``params_from_numpy`` takes the reference's parameter tree as nested dicts
of numpy arrays (the caller converts, e.g.
``jax.tree.map(lambda a: np.asarray(a, np.float32), params)``) and returns
the port's tree, leaf for leaf, each leaf in the dtype that the port's own
``Model.init`` gives it: ``cfg.dtype`` for most, float32 for the leaves the
model keeps in float32 whatever ``cfg.dtype`` (Mamba-1's ``dt_proj``,
``dt_bias``, ``A_log`` and ``D``).  bfloat16 leaves arrive as float32 numpy,
and casting them back is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import model as model_lib


def params_from_numpy(tree: dict, cfg: ModelConfig,
                      device: str | torch.device = "cuda") -> dict:
    dev = resolve(device)
    dtypes = model_lib.Model(cfg, dev).param_dtypes()

    def walk(src: dict, want: dict, path: str) -> dict:
        if src.keys() != want.keys():
            raise KeyError(f"parameter tree at {path or '/'} has keys "
                           f"{sorted(src)}, the model's {sorted(want)}")
        out = {}
        for k, v in src.items():
            if isinstance(v, dict):
                out[k] = walk(v, want[k], f"{path}/{k}")
                continue
            a = np.asarray(v)
            if not np.issubdtype(a.dtype, np.floating):
                raise TypeError(f"non-float parameter leaf {path}/{k} of "
                                f"dtype {a.dtype}")
            out[k] = torch.from_numpy(np.array(a)).to(device=dev,
                                                      dtype=want[k])
        return out

    return walk(tree, dtypes, "")
