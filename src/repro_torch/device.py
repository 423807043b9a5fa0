"""Device resolution for the port's entry points: CUDA unless the caller
asks for the CPU, and never a silent fallback."""
from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU unless the "
            "CPU is requested explicitly (--device cpu / device='cpu')")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return dev
