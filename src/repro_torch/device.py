"""Device choice for the port's entry points.

Every entry point takes ``device=``: ``None`` means the CUDA card, and a
machine without one raises instead of carrying on quietly on the CPU.
The CPU runs only when the caller names it (the tests pass
``device="cpu"``), and then every kernel wrapper takes its plain
PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the card's work on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
