"""The kernels' ops on tensors that hold no data to launch on: DTensors and
fake tensors.

A wrapper routes such an input to its ``torch.library`` custom op and
never to code that reads ``data_ptr()``.  Under ``FakeTensorMode`` the op's
fake implementation gives the kernel's output shapes and dtypes; on
DTensors the op's sharding rule (``register_sharding``) says which
placements it takes, and DTensor runs the op on each rank's local shards,
where the op's own implementation launches the kernel (or, on the CPU,
runs its plain version).  Each op also has a ``FlopCounterMode`` formula.
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor, Replicate


def symbolic(*ts) -> bool:
    """Whether any of ``ts`` is a DTensor or a fake tensor."""
    return any(isinstance(t, (DTensor, FakeTensor)) for t in ts)


def is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def to_layout(t: torch.Tensor, mesh, placements=None) -> DTensor:
    """``t`` as a DTensor on ``mesh`` with ``placements`` (None: as it is;
    a plain tensor counts as replicated); no collective when it already
    is."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if placements is None or tuple(t.placements) == tuple(placements):
        return t
    return t.redistribute(mesh, placements)
