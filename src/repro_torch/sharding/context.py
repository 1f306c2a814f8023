"""Ambient mesh context so model code can apply sharding constraints
without threading a mesh through every call signature (PyTorch port of
``repro/sharding/context.py``).

``constrain(x, *spec)`` is the identity when no mesh is active.  Under an
active ``DeviceMesh`` it redistributes a ``DTensor`` to the spec's
placements; a plain local tensor passes through unchanged, since eager
PyTorch has no GSPMD to hand a layout constraint to.

Under ``use_mesh`` with a ``DeviceMesh``, plain tensors that meet DTensors
in an op (positions, masks, scalars the model makes) count as replicated
(``implicit_replication``), as XLA treats an unsharded constant.
"""

from __future__ import annotations

import contextlib
import threading
from collections.abc import Mapping

import torch

from repro_torch.sharding import partition

_state = threading.local()
# DTensor's ``implicit_replication`` flag is per thread (torch 2.11 and
# 2.13) and not reentrant: leaving a block turns it off.  So each thread
# counts its open ``use_mesh`` blocks (``_state.depth``) and enters one
# ``implicit_replication`` for all of them (a card's backward runs in the
# autograd engine's thread, and a remat recompute enters a block there)


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    prev = current_mesh()
    _state.mesh = mesh
    replicate = mesh is not None and not isinstance(mesh, Mapping)
    if replicate:
        _enter_replication()
    try:
        yield mesh
    finally:
        _state.mesh = prev
        if replicate:
            _exit_replication()


def _enter_replication() -> None:
    depth = getattr(_state, "depth", 0)
    if depth == 0:
        from torch.distributed.tensor.experimental import implicit_replication

        cm = implicit_replication()
        cm.__enter__()
        _state.replication = cm
    _state.depth = depth + 1


def _exit_replication() -> None:
    _state.depth -= 1
    if _state.depth == 0:
        cm, _state.replication = _state.replication, None
        cm.__exit__(None, None, None)


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """Apply a spec constraint if a mesh is active and ``x`` is a DTensor.

    Spec entries may name axes that don't exist on the active mesh; they are
    dropped (so model code can say ("pod", "data") and work on both meshes).
    """
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    names = set(partition.axis_sizes(mesh))

    def keep(e):
        if e is None:
            return None
        if isinstance(e, (tuple, list)):
            kept = tuple(a for a in e if a in names)
            return kept if kept else None
        return e if e in names else None

    cleaned = partition.spec(*(keep(e) for e in spec))
    return x.redistribute(mesh, partition.to_placements(cleaned, mesh))
