"""Plain PyTorch versions of the SSM state-arena ops (the JAX package's
``kernels/ssm_scan/ref.py``), on the flattened ``(L, R, E)`` arena:
``L`` is groups x Mamba sublayers, ``R`` the state rows (one per live
sequence).  They update the arena in place; the wrappers in :mod:`.ops`
run them on CPU tensors, and the kernel is held against them on the
card.
"""

from __future__ import annotations

import torch


def state_scatter(arena: torch.Tensor, rows: torch.Tensor,
                  new: torch.Tensor) -> torch.Tensor:
    """``arena[:, rows[b]] <- new[:, b]``.  arena: (L, R, E); rows: (B,);
    new: (L, B, E).  Duplicate rows carry identical payloads by the
    caller's contract, so the order of the writes does not matter."""
    arena[:, rows.long()] = new.to(arena.dtype)
    return arena


def state_gather(arena: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``arena[:, rows[b]]`` -> (L, B, E), the scatter's inverse."""
    return arena[:, rows.long()]
