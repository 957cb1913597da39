"""Explicit device selection: the port never picks a device on its own."""

from __future__ import annotations

import torch


def get_device(name: str) -> torch.device:
    """``"cpu"`` or ``"cuda"`` / ``"cuda:N"``. A CUDA device without a
    visible GPU raises instead of quietly running on the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but no CUDA GPU is "
                           "visible to torch")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {name!r} (cpu | cuda)")
    return dev
