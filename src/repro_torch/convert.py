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

``taskgraph_from_numpy`` carries a simulator task graph of the reference
(``repro.core.ir.TaskGraph``: its array fields as numpy arrays, plus
``tags``) into the port's :class:`~repro_torch.core.ir.TaskGraph`, field
for field in the same dtypes, so one graph can be scheduled by both;
``taskgraph_to_numpy`` is its inverse, so placed, optimised and lowered
graphs of both packages can be compared array by array.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import ir
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


def taskgraph_from_numpy(fields: dict) -> ir.TaskGraph:
    """A reference task graph's fields -> the port's (host) TaskGraph.

    ``fields`` maps each of :data:`repro_torch.core.ir.ARRAY_FIELDS` to a
    numpy array (e.g. ``{f: getattr(g, f) for f in ir.ARRAY_FIELDS}``) and
    ``tags`` to a tuple of strings or None.  The arrays keep their values
    and dtypes (int8 kinds, int16 op classes, bool ``dst_is_tuple``, int64
    and float64 for the rest); the result is frozen like a built graph.
    """
    want = {"uids": torch.int64, "kinds": torch.int8,
            "dep_indptr": torch.int64, "dep_pos": torch.int64,
            "duration": torch.float64, "op_class": torch.int16,
            "pe": torch.int64, "src": torch.int64,
            "dst_indptr": torch.int64, "dst_flat": torch.int64,
            "dst_is_tuple": torch.bool, "rows": torch.int64}
    missing = set(ir.ARRAY_FIELDS) - set(fields)
    if missing:
        raise KeyError(f"task graph fields missing: {sorted(missing)}")
    arrays = {}
    for f in ir.ARRAY_FIELDS:
        t = torch.from_numpy(np.array(fields[f]))
        if t.dtype != want[f]:
            raise TypeError(f"task graph field {f!r} has dtype {t.dtype}, "
                            f"want {want[f]}")
        arrays[f] = t
    tags = fields.get("tags")
    return ir.freeze(ir.TaskGraph(**arrays,
                                  tags=None if tags is None else tuple(tags)))


def taskgraph_to_numpy(g: ir.TaskGraph) -> dict:
    """The port's task graph -> its fields: each of
    :data:`repro_torch.core.ir.ARRAY_FIELDS` as a numpy array in its own
    dtype (a copy), and ``tags``.  The inverse of
    :func:`taskgraph_from_numpy`; ``repro.core.ir.TaskGraph(**fields)``
    builds the reference's graph from it."""
    out = {f: getattr(g, f).numpy().copy() for f in ir.ARRAY_FIELDS}
    out["tags"] = g.tags
    return out
