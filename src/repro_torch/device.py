"""Device resolution: ``cuda`` unless the caller asks for the CPU.

There is no fallback: asking for ``cuda`` on a host without a card raises.
"""

from __future__ import annotations

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
