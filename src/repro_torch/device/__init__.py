"""Device resolution, and the device-scale Shared-PIM simulator (PyTorch port
of ``repro/device/``).

:func:`resolve` picks the torch device an entry point runs on: ``cuda``
unless the caller asks for the CPU.  There is no fallback: asking for
``cuda`` on a host without a card raises.

The simulator's device layer scales the single-bank model
(:mod:`repro_torch.core`) to a whole DRAM device:

``geometry``      subarray -> bank -> bank group -> channel hierarchy
``interconnect``  inter-bank / cross-channel transfer cost models
``resources``     DeviceModel: the hierarchy as engine resource tokens
``scheduler``     thin shim: DeviceModel + engine -> DeviceScheduleResult
``partition``     placement policies that split apps across N banks
``batch``         BatchRunner: N sweep configurations in one call
``reference``     preserved legacy scheduler (differential tests, baselines)

Its public names are re-exported here *lazily* (PEP 562): every module of
the port imports :func:`resolve` from this package, the engine included,
and ``resources`` imports the engine back, so an eager import of the
submodules would be circular; it would also pull the simulator into every
model import.  ``from repro_torch import device; device.DeviceGeometry``
imports ``device.geometry`` on first use.

Quickstart::

    from repro_torch.core.pluto import Interconnect
    from repro_torch import device

    geom = device.DeviceGeometry(channels=2, banks_per_channel=4,
                                 bank_groups_per_channel=2)
    tasks = device.build_partitioned("mm", Interconnect.LISA, geom,
                                     policy="locality_first", n=200)
    res = device.compare(tasks, geom)
    print(device.improvement(res), res["shared_pim"].rows_by_route)
"""

from __future__ import annotations

import importlib

import torch


def resolve(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


#: the simulator's public names -> the submodule that defines each
_EXPORTS = {
    "BatchRunner": "batch", "SweepConfig": "batch",
    "SINGLE_BANK": "geometry", "DeviceGeometry": "geometry",
    "CrossBankPlan": "interconnect", "plan": "interconnect",
    "transit_ns_per_row": "interconnect",
    "POLICIES": "partition", "build_partitioned": "partition",
    "build_partitioned_ir": "partition", "cross_traffic_rows": "partition",
    "optimization_log": "partition", "optimized_struct": "partition",
    "pe_map": "partition", "place": "partition",
    "DeviceModel": "resources",
    "DeviceScheduleResult": "scheduler", "compare": "scheduler",
    "improvement": "scheduler", "schedule": "scheduler",
}
_SUBMODULES = ("batch", "geometry", "interconnect", "partition", "reference",
               "resources", "scheduler")


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    sub = _EXPORTS.get(name)
    if sub is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{sub}"), name)
    globals()[name] = value
    return value
