"""Wrappers for the D-RaNGe generator kernels (``csrc/drange.cu``).

The port's counterpart of the JAX package's ``kernels/drange/ops.py``:
``pim_random_u32`` (the words, one ``dr_random_u32`` launch) and
``pim_random_uniform`` (the top 24 bits of each word times 2**-24,
written as float32 by one ``dr_random_uniform`` launch, with an
optional device row map that gathers rows in the same launch: the
token choice's whole draw).  Both count under ``random_u32``.  The seed
is a host value, two uint32 words, so no launch waits on the card; a
pair of Python ints is taken as it is, anything else through numpy.
The wrappers keep their host work small, since the sampled path draws
8 uniforms between graph replays: the loaded library and the raw
current stream are fetched without building stream or device objects.
On the CPU a wrapper runs the plain version in :mod:`.ref`; on a CUDA
device it launches the kernel or raises.  The words come back as
``torch.uint32``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import _build, count_launch
from . import ref

Seed = Union[Sequence[int], np.ndarray, torch.Tensor]


def host_seed(seed: Seed) -> Tuple[int, int]:
    """The seed as two Python ints in [0, 2**32).  A CUDA tensor is
    read back (a device sync); the engine passes a tuple of ints."""
    if isinstance(seed, tuple) and len(seed) == 2 \
            and type(seed[0]) is int and type(seed[1]) is int:
        return seed[0] & ref.MASK, seed[1] & ref.MASK
    if isinstance(seed, torch.Tensor):
        seed = seed.detach().cpu().numpy()
    words = [int(w) & ref.MASK for w in np.asarray(seed).reshape(-1)]
    if len(words) != 2:
        raise ValueError(f"a seed is two uint32 words, not {len(words)}")
    return words[0], words[1]


def _device(device) -> torch.device:
    return device if isinstance(device, torch.device) \
        and device.type == "cuda" else resolve_device(device)


def pim_random_u32(seed: Seed, n_rows: int, n_cols: int,
                   device: DeviceLike = None) -> torch.Tensor:
    """(n_rows, n_cols) uint32 words of Threefry2x32-20 over the flat
    element counter, keyed by ``seed``."""
    dev = _device(device)
    k0, k1 = host_seed(seed)
    if dev.type == "cpu":
        return ref.random_u32((k0, k1), n_rows, n_cols,
                              dev).view(torch.uint32)
    if dev.type != "cuda":
        raise ValueError(f"no D-RaNGe kernel for device {dev}")
    out = torch.empty((n_rows, n_cols), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out.view(torch.uint32)
    _build.check(_build.load("drange").dr_random_u32(
        k0, k1, out.data_ptr(), out.numel(),
        torch._C._cuda_getCurrentRawStream(out.get_device())), "random_u32")
    count_launch("random_u32")
    return out.view(torch.uint32)


def pim_random_uniform(seed: Seed, n_rows: int, n_cols: int,
                       device: DeviceLike = None,
                       rowmap: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Uniform float32 in [0, 1) from the top 24 bits of each word of
    :func:`pim_random_u32`: (n_rows, n_cols), or with ``rowmap`` (int64
    row indices in [0, n_rows), on the device) its rows ``rowmap``,
    (len(rowmap), n_cols), in one launch.  The indices are not checked
    on the card (that would wait for it): an index out of range draws
    the counters of a row past ``n_rows``."""
    dev = _device(device)
    k0, k1 = host_seed(seed)
    if dev.type == "cpu":
        return ref.random_uniform((k0, k1), n_rows, n_cols, dev,
                                  rowmap=rowmap)
    if dev.type != "cuda":
        raise ValueError(f"no D-RaNGe kernel for device {dev}")
    rows, rm = n_rows, None
    if rowmap is not None:
        if rowmap.dtype != torch.int64 or rowmap.dim() != 1 \
                or not rowmap.is_cuda or not rowmap.is_contiguous():
            raise ValueError("rowmap must be a contiguous 1-d int64 tensor "
                             "on the card")
        rows, rm = rowmap.shape[0], rowmap.data_ptr()
    out = torch.empty((rows, n_cols), dtype=torch.float32, device=dev)
    if rm is not None and rowmap.get_device() != out.get_device():
        raise ValueError(f"rowmap is on {rowmap.device}, the draw on "
                         f"{out.device}")
    if out.numel() == 0:
        return out
    _build.check(_build.load("drange").dr_random_uniform(
        k0, k1, out.data_ptr(), out.numel(), n_cols, rm,
        torch._C._cuda_getCurrentRawStream(out.get_device())), "random_u32")
    count_launch("random_u32")
    return out


def entropy_seed_from_trng(trng, stream: int = 0) -> Tuple[int, int]:
    """Fold 64 true-random bits from the simulated-DRAM D-RaNGe TRNG
    (:class:`repro_torch.core.drange.DRangeTRNG`) into a kernel seed:
    the bridge between the paper's entropy source and the generator
    kernel.  ``stream`` is xor-ed into the first word."""
    words = trng.random_u32(2)
    return ((int(words[0]) ^ int(stream)) & ref.MASK,
            int(words[1]) & ref.MASK)
