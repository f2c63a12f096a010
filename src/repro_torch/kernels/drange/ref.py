"""Plain PyTorch version of the D-RaNGe generator (the JAX package's
``kernels/drange/ref.py``): Threefry2x32 with 20 rounds over the flat
element counter, bit for bit the arithmetic of the CUDA kernel.

PyTorch on the CPU has no uint32 add or shift, so the words are held in
int64 and masked to 32 bits after every add and rotate.  The result is
returned as the uint32 bit pattern in an int32 tensor (what the kernel
writes); :mod:`.ops` views it as ``torch.uint32``.
"""

from __future__ import annotations

from typing import Tuple

import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
CTR_XOR = 0x9E3779B9


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0: int, k1: int, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """20-round Threefry2x32 on int64 tensors that hold uint32 words."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for block in range(5):
        for r in ROTATIONS[block % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r)
            x1 = x0 ^ x1
        x0 = (x0 + ks[(block + 1) % 3]) & MASK
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & MASK
    return x0, x1


def random_u32(seed: Tuple[int, int], n_rows: int, n_cols: int,
               device: torch.device) -> torch.Tensor:
    """(n_rows, n_cols) words from the (2,) uint32 seed, as int32 bits."""
    ctr = torch.arange(n_rows * n_cols, dtype=torch.int64, device=device)
    ctr = ctr & MASK
    x0, _ = threefry2x32(seed[0], seed[1], ctr, ctr ^ CTR_XOR)
    x0 = torch.where(x0 >= 1 << 31, x0 - (1 << 32), x0)
    return x0.to(torch.int32).reshape(n_rows, n_cols)
