"""Parameter transfer from the JAX reference package.

``params_from_numpy`` takes the reference's parameter tree as nested dicts
of numpy arrays (the caller converts, e.g.
``jax.tree.map(lambda a: np.asarray(a, np.float32), params)``) and returns
the port's tree, leaf for leaf, each leaf in the dtype that the port's own
``Model.init`` gives it: ``cfg.dtype`` for most, float32 for the leaves the
model keeps in float32 whatever ``cfg.dtype`` (Mamba-1's ``dt_proj``,
``dt_bias``, ``A_log`` and ``D``).  bfloat16 leaves arrive as float32 numpy,
and casting them back is exact.

``train_state_from_numpy`` carries a whole train state of the reference
(``repro.train.train_step.make_train_state``: params, AdamW moments as
float32 or as 8-bit ``{"c", "s"}`` codes and scales, and the two step
counters) into the port's, so that both packages can start from one state.
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


def train_state_from_numpy(state: dict, cfg: ModelConfig,
                           device: str | torch.device = "cuda") -> dict:
    """The reference's train state as nested dicts of numpy arrays -> the
    port's: params as ``params_from_numpy``, moments in their own dtype
    (float32, or int8 codes and float32 scales), steps as int32 scalars."""
    dev = resolve(device)
    if set(state) != {"params", "opt", "step"}:
        raise KeyError(f"train state has keys {sorted(state)}; want opt, "
                       "params, step (no pod-compression error state)")

    def moments(t):
        if isinstance(t, dict):
            return {k: moments(v) for k, v in t.items()}
        a = np.asarray(t)
        if a.dtype not in (np.float32, np.int8):
            raise TypeError(f"optimizer moment of dtype {a.dtype}")
        return torch.from_numpy(np.array(a)).to(dev)

    def step(a):
        return torch.tensor(int(np.asarray(a)), dtype=torch.int32,
                            device=dev)

    opt = state["opt"]
    return {"params": params_from_numpy(state["params"], cfg, dev),
            "opt": {"m": moments(opt["m"]), "v": moments(opt["v"]),
                    "step": step(opt["step"])},
            "step": step(state["step"])}
