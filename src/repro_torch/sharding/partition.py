"""Sharding rules: parameter / cache / activation leaves -> specs (PyTorch
port of ``repro/sharding/partition.py``).

Strategy (the reference's):

* ``data`` mesh axis = DP + FSDP: every weight is additionally sharded over
  'data' on its d_model-ish dimension.
* ``model`` mesh axis = TP/EP: heads / ffn / expert dimensions.
* ``pod`` mesh axis (multi-pod) = extra pure-DP dimension; the batch is
  sharded over ('pod', 'data') jointly.

All assignments are divisibility-checked per tensor; a dimension that does
not divide stays unsharded, so every architecture gets a spec on every
mesh without per-arch rules.

The rules are pure: a mesh is its axis names and sizes, either a
``torch.distributed.device_mesh.DeviceMesh`` or a plain ``{axis: size}``
mapping, so specs are computed without a process group.  A spec is a tuple
with one entry per tensor dimension: an axis name, a tuple of axis names,
or ``None`` (the entries of the reference's ``PartitionSpec``, which also
writes a one-name tuple as the name).  ``to_placements`` turns one into
DTensor placements.  A leaf's path is the port's tree path
(``"/blocks/attn/wq"``, as ``repro_torch.tree.items`` gives it) or a
sequence of its keys.

``param_shardings``, ``batch_shardings`` and ``cache_shardings`` map a tree
of tensors (real or fake) to a tree of DTensor placements on a
``DeviceMesh``, as the reference's map a tree to ``NamedSharding``s;
``distribute`` builds the DTensors, each from its rank's local shard
(``DTensor.from_local``), so distributing a fake tree runs no collective.
"""

from __future__ import annotations

import math
import os
from collections.abc import Mapping, Sequence
from typing import Any

Spec = tuple

# Preferred (mesh_axis -> tensor dim chooser) per parameter leaf name.
# Dims are indexed AFTER stripping the leading layer-stack dimension.
# Each entry: list of (dim, mesh_axis) preferences tried in order.
_NAME_RULES: dict[str, list[tuple[int, str]]] = {
    # (V, d)
    "embed": [(0, "model"), (1, "data")],
    # (d, V)
    "unembed": [(1, "model"), (0, "data")],
    # attention: (d, H, Dh) / (H, Dh, d)
    "wq": [(1, "model"), (0, "data")],
    "wk": [(1, "model"), (0, "data")],
    "wv": [(1, "model"), (0, "data")],
    # (d, f) mlp in / (f, d) mlp out — also matches attn wo (H, Dh, d) via
    # ndim dispatch below
    "wi_gate": [(1, "model"), (0, "data")],
    "wi_up": [(1, "model"), (0, "data")],
    # ssm
    "in_proj": [(1, "model"), (0, "data")],
    "out_proj": [(0, "model"), (1, "data")],
    "x_proj": [(0, "model")],
    "bc_proj": [(0, "data")],
    "dt_proj": [(1, "model")],
    "dt_proj_h": [(0, "data")],
    "conv_w": [(1, "model")],
    "conv_b": [(0, "model")],
    "A_log": [(0, "model")],
    "D": [(0, "model")],
    # moe: router (d, E); expert weights (E, d, f) / (E, f, d)
    "router": [(0, "data")],
    # media
    "media_proj": [(1, "model"), (0, "data")],
}


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` or of a mapping."""
    if isinstance(mesh, Mapping):
        return {str(a): int(s) for a, s in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def spec(*entries) -> Spec:
    """A spec from its entries, a one-name tuple written as the name (as
    ``PartitionSpec`` does)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _keys(path) -> list[str]:
    if isinstance(path, str):
        return [k for k in path.split("/") if k]
    return [str(k) for k in path]


def _leaf_name(path) -> str:
    keys = _keys(path)
    return keys[-1] if keys else ""


def _path_has(path, *names) -> bool:
    keys = set(_keys(path))
    return any(n in keys for n in names)


def _stacked(path) -> bool:
    """Leaves under blocks/moe_blocks/cross_blocks/shared_attn carry a
    leading layer-stack dimension that must never be sharded."""
    return _path_has(path, "blocks", "moe_blocks", "cross_blocks",
                     "shared_attn")


def param_spec(path, shape: Sequence[int], mesh) -> Spec:
    """Spec for one parameter leaf."""
    shape = tuple(shape)
    axes = axis_sizes(mesh)
    tp = axes.get("model", 1)
    dp = axes.get("data", 1)
    off = 1 if _stacked(path) else 0
    dims = shape[off:]
    out: list[Any] = [None] * len(shape)

    name = _leaf_name(path)
    used_axes: set[str] = set()

    def try_assign(dim: int, axis: str) -> None:
        size = {"model": tp, "data": dp}[axis]
        d = dim + off
        if (axis not in used_axes and d < len(shape) and out[d] is None
                and shape[d] % size == 0 and size > 1):
            out[d] = axis
            used_axes.add(axis)

    # moe expert tensors: EP if expert count divides, else TP on ffn dim
    if name in ("wi_gate", "wi_up", "wo") and len(dims) == 3 and \
            _path_has(path, "moe"):
        E, a, b = dims
        # REPRO_MOE_TP=1 forces TP-on-ffn expert sharding even when the
        # expert count divides (the reference's rule, read the same way)
        if E % tp == 0 and not os.environ.get("REPRO_MOE_TP"):
            try_assign(0, "model")
            try_assign(1, "data")
        else:
            ff_dim = 2 if name != "wo" else 1
            try_assign(ff_dim, "model")
            try_assign(1 if name != "wo" else 2, "data")
    elif name == "wo" and len(dims) == 3:         # attn wo: (H, Dh, d)
        try_assign(0, "model")
        try_assign(2, "data")
    elif name == "wo" and len(dims) == 2:         # mlp wo: (f, d)
        try_assign(0, "model")
        try_assign(1, "data")
    elif name in _NAME_RULES:
        for dim, axis in _NAME_RULES[name]:
            try_assign(dim, axis)
    else:
        # generic fallback: biggest dim -> model, next -> data
        order = sorted(range(len(dims)), key=lambda i: -dims[i])
        if order:
            try_assign(order[0], "model")
        if len(order) > 1:
            try_assign(order[1], "data")
    return spec(*out)


# --- batch / activations / cache -------------------------------------------

def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes the global batch is sharded over."""
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def batch_spec(mesh, global_batch: int) -> Spec:
    axes = batch_axes(mesh)
    size = math.prod(axis_sizes(mesh)[a] for a in axes)
    if axes and global_batch % size == 0:
        return spec(axes)
    return spec()


def cache_spec(path, shape: Sequence[int], mesh, batch_size: int) -> Spec:
    """Decode-cache leaf sharding: batch over data axes; heads/channels over
    model; for unshardable batch (e.g. long_500k B=1) shard the sequence
    dimension of KV over 'data' instead."""
    shape = tuple(shape)
    axes = axis_sizes(mesh)
    tp = axes.get("model", 1)
    dsize = math.prod(axes[a] for a in batch_axes(mesh))
    name = _leaf_name(path)
    out: list[Any] = [None] * len(shape)
    if name in ("k", "v", "media_k", "media_v"):
        # (L, B, S, K, Dh)
        if shape[1] % dsize == 0 and dsize > 1:
            out[1] = batch_axes(mesh)
        elif shape[2] % dsize == 0 and dsize > 1:
            out[2] = batch_axes(mesh)          # sequence-sharded KV
        if shape[3] % tp == 0 and tp > 1:
            out[3] = "model"
        elif out[2] is None and shape[2] % tp == 0 and tp > 1:
            out[2] = "model"
    elif name in ("conv", "h"):
        if shape[1] % dsize == 0 and dsize > 1:
            out[1] = batch_axes(mesh)
        for d in range(len(shape) - 1, 1, -1):
            if shape[d] % tp == 0 and tp > 1:
                out[d] = "model"
                break
    return spec(*out)


def activation_spec(mesh) -> Spec:
    """(B, T, D) residual-stream constraint: batch over data, seq over model
    (sequence parallelism between blocks)."""
    names = axis_sizes(mesh)
    return spec(batch_axes(mesh) or None,
                "model" if "model" in names else None, None)


def _map_paths(fn, t, prefix: str = ""):
    if isinstance(t, dict):
        return {k: _map_paths(fn, v, f"{prefix}/{k}") for k, v in t.items()}
    return fn(prefix or "/", t)


def _is_tensor(leaf) -> bool:
    import torch

    return isinstance(leaf, torch.Tensor)


def param_shardings(params, mesh):
    """Placements of every leaf of a parameter (or train state) tree;
    a leaf that is not a tensor maps to None."""
    return _map_paths(
        lambda path, leaf: to_placements(
            param_spec(path, leaf.shape, mesh), mesh)
        if _is_tensor(leaf) else None, params)


def batch_shardings(batch, mesh, global_batch: int):
    """Placements of every leaf of a batch: the batch spec on a leaf whose
    leading dimension is the global batch, replicated otherwise."""
    bspec = batch_spec(mesh, global_batch)
    return _map_paths(
        lambda path, leaf: to_placements(
            bspec if leaf.dim() and leaf.shape[0] == global_batch
            else spec(), mesh) if _is_tensor(leaf) else None, batch)


def cache_shardings(cache, mesh, batch_size: int):
    """Placements of every leaf of a decode cache (its ``pos``, a Python
    int, maps to None)."""
    return _map_paths(
        lambda path, leaf: to_placements(
            cache_spec(path, leaf.shape, mesh, batch_size)
            if leaf.dim() else spec(), mesh)
        if _is_tensor(leaf) else None, cache)


def local_shape_and_offset(shape, mesh, placements
                           ) -> tuple[list[int], list[int]]:
    """This rank's shard of a tensor of global ``shape`` under
    ``placements``: its shape and its offset in the global tensor.  Mesh
    dimensions shard in order, each as ``torch.chunk`` cuts (so shards may
    be uneven or empty), DTensor's layout; plain ints, so it runs under a
    ``FakeTensorMode`` too."""
    from torch.distributed.tensor import Shard

    size, off = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if not isinstance(p, Shard):
            continue
        n, c, d = mesh.size(i), coord[i], p.dim
        chunk = -(-size[d] // n)
        lo = min(c * chunk, size[d])
        off[d] += lo
        size[d] = min(size[d], lo + chunk) - lo
    return size, off


def local_shard(t, mesh, placements):
    """This rank's shard of the global tensor ``t`` under ``placements``
    (a narrowed view)."""
    shape, offset = local_shape_and_offset(t.shape, mesh, placements)
    for d, (n, o) in enumerate(zip(shape, offset)):
        if n != t.shape[d]:
            t = t.narrow(d, o, n)
    return t


def distribute(t, placements, mesh):
    """A tree of DTensors: each tensor leaf of ``t`` with its placements
    from the tree ``placements`` (``param_shardings`` and the like), built
    by ``DTensor.from_local`` on a contiguous copy of this rank's shard of
    the leaf (so the DTensors never alias ``t``).  Non-tensor leaves pass
    through."""
    import torch
    from torch.distributed.tensor import DTensor

    def one(leaf, pl):
        if not _is_tensor(leaf) or pl is None:
            return leaf
        local = local_shard(leaf.detach(), mesh, pl).clone(
            memory_format=torch.contiguous_format)
        out = DTensor.from_local(local, mesh, pl, run_check=False,
                                 shape=leaf.shape,
                                 stride=contiguous_strides(leaf.shape))
        return out.requires_grad_(leaf.requires_grad)

    if isinstance(t, dict):
        return {k: distribute(v, placements[k], mesh) for k, v in t.items()}
    return one(t, placements)


def contiguous_strides(shape) -> tuple[int, ...]:
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(out))


def to_placements(entries: Spec, mesh) -> tuple:
    """DTensor placements of a spec on ``mesh``: ``Shard(d)`` on each mesh
    dimension that names tensor dimension d, ``Replicate()`` elsewhere.  A
    dimension sharded over several axes takes them in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_sizes(mesh))
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(entries):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if not isinstance(out[names.index(axis)], Replicate):
                raise ValueError(f"mesh axis {axis!r} used twice in "
                                 f"{entries}")
            out[names.index(axis)] = Shard(d)
    return tuple(out)
