"""Where the port's tensors live: the GPU unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, ``cuda`` when None.  Raises when CUDA is
    asked for and there is none: the CPU runs only when named."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device``; nothing to wait for on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
