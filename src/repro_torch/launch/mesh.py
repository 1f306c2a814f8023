"""Production mesh construction (PyTorch port of ``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module never touches
the process group.  Each builds a ``DeviceMesh`` over the default process
group, which the caller starts first: the dry-run starts a ``fake`` group
of 256 or 512 ranks (``launch/dryrun.py``), a real run its NCCL or gloo
group.  The device type is ``"cuda"`` unless the caller asks for
``"cpu"``.
"""

from __future__ import annotations

import torch.distributed as dist


def _mesh(device: str, shape: tuple[int, ...], axes: tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("start a process group first "
                           "(torch.distributed.init_process_group)")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """16x16 = 256-card pod; multi_pod adds a 2-pod leading axis (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device, shape, axes)


def make_host_mesh(device: str = "cuda"):
    """Degenerate (1, world) mesh over whatever group exists."""
    return _mesh(device, (1, dist.get_world_size()), ("data", "model"))
