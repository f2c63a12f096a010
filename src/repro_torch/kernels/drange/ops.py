"""Wrappers for the D-RaNGe generator kernel (``csrc/drange.cu``).

The port's counterpart of the JAX package's ``kernels/drange/ops.py``:
``pim_random_u32`` and ``pim_random_uniform`` (the top 24 bits of each
word times 2**-24).  The seed is a host value, two uint32 words, so no
launch waits on the card.  On the CPU the wrapper runs the plain version
in :mod:`.ref`; on a CUDA device it launches the kernel or raises.  The
words come back as ``torch.uint32``.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import _build, count_launch
from . import ref

Seed = Union[Sequence[int], np.ndarray, torch.Tensor]


def host_seed(seed: Seed) -> Tuple[int, int]:
    """The seed as two Python ints in [0, 2**32).  A CUDA tensor is
    read back (a device sync); the engine passes host values."""
    if isinstance(seed, torch.Tensor):
        seed = seed.detach().cpu().numpy()
    words = [int(w) & ref.MASK for w in np.asarray(seed).reshape(-1)]
    if len(words) != 2:
        raise ValueError(f"a seed is two uint32 words, not {len(words)}")
    return words[0], words[1]


def _random_bits(seed: Seed, n_rows: int, n_cols: int,
                 device: DeviceLike) -> torch.Tensor:
    """The words as int32 bit patterns, (n_rows, n_cols)."""
    dev = resolve_device(device)
    k0, k1 = host_seed(seed)
    if dev.type == "cpu":
        return ref.random_u32((k0, k1), n_rows, n_cols, dev)
    if dev.type != "cuda":
        raise ValueError(f"no D-RaNGe kernel for device {dev}")
    out = torch.empty((n_rows, n_cols), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.load("drange")
    _build.check(lib.dr_random_u32(
        k0, k1, out.data_ptr(), out.numel(),
        torch.cuda.current_stream(dev).cuda_stream), "random_u32")
    count_launch("random_u32")
    return out


def pim_random_u32(seed: Seed, n_rows: int, n_cols: int,
                   device: DeviceLike = None) -> torch.Tensor:
    """(n_rows, n_cols) uint32 words of Threefry2x32-20 over the flat
    element counter, keyed by ``seed``."""
    return _random_bits(seed, n_rows, n_cols, device).view(torch.uint32)


def pim_random_uniform(seed: Seed, n_rows: int, n_cols: int,
                       device: DeviceLike = None) -> torch.Tensor:
    """Uniform float32 in [0, 1) from the top 24 bits of each word."""
    bits = _random_bits(seed, n_rows, n_cols, device)
    return ((bits >> 8) & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24))


def entropy_seed_from_trng(trng, stream: int = 0) -> Tuple[int, int]:
    """Fold 64 true-random bits from the simulated-DRAM D-RaNGe TRNG
    (:class:`repro_torch.core.drange.DRangeTRNG`) into a kernel seed:
    the bridge between the paper's entropy source and the generator
    kernel.  ``stream`` is xor-ed into the first word."""
    words = trng.random_u32(2)
    return ((int(words[0]) ^ int(stream)) & ref.MASK,
            int(words[1]) & ref.MASK)
