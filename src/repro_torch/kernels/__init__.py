"""Hand-written Hopper kernels of the port, with their plain PyTorch
versions.

Each subpackage holds ``ops.py`` (the wrapper: on a CUDA tensor it
launches the kernel built from ``csrc/`` or raises, on a CPU tensor it
runs the plain version in ``ref.py``) and ``ref.py``.  Every kernel
launch adds one to its entry in :data:`LAUNCHES`; launches of the plain
version add nothing, so a run on the card can show which kernels its
path went through.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Mapping

#: kernel name -> launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {
    "kv_scatter": 0,
    "page_copy_batched": 0,
    "page_init_batched": 0,
    "paged_attention": 0,
    "flash_attention": 0,
    # the same kernel in its prefix-KV mode (chunked prefill)
    "flash_attention_prefix": 0,
    "random_u32": 0,
    "page_bitwise_batched": 0,
    "page_not_batched": 0,
    "page_zero_scan": 0,
    "state_scatter": 0,
    # the paged decode's SSD state update, one launch a Mamba sublayer
    "ssd_step": 0,
    # the RowClone API's single-buffer movers (copy_2d, init_2d) and
    # one-layer page ops (page_copy, page_init)
    "copy_2d": 0,
    "init_2d": 0,
    "page_copy": 0,
    "page_init": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def count_launch(name: str, n: int = 1) -> None:
    LAUNCHES[name] += n


#: kernel name -> the device kernel whose runs it counts, as a pattern of
#: the name a profiler gives it; names that share a kernel share it
DEVICE_KERNEL = {
    "kv_scatter": "kv_scatter_kernel",
    "page_copy_batched": "page_rows(_cluster)?_kernel.*CopyOp",
    "page_copy": "page_rows(_cluster)?_kernel.*CopyOp",
    "page_init_batched": "init_rows_kernel",
    "page_init": "init_rows_kernel",
    "paged_attention": "paged_split_kernel",
    "flash_attention": "flash_(tc|simt)_kernel",
    "flash_attention_prefix": "flash_(tc|simt)_kernel",
    "random_u32": "drange_(uniform_)?kernel",
    "page_bitwise_batched": "page_rows(_cluster)?_kernel.*(And|Or)Op",
    "page_not_batched": "page_rows(_cluster)?_kernel.*NotOp",
    "page_zero_scan": "zero_scan_kernel",
    "state_scatter": "state_scatter_kernel",
    "ssd_step": "ssd_step_kernel",
    "copy_2d": "copy_flat_kernel",
    "init_2d": "fill_flat_kernel",
}


def device_kernel_counts(counts: Mapping[str, int]) -> Dict[str, int]:
    """Launch counts (as :data:`LAUNCHES` keeps them) by device kernel."""
    out: Dict[str, int] = {}
    for name, n in counts.items():
        if n:
            k = DEVICE_KERNEL[name]
            out[k] = out.get(k, 0) + n
    return out


def ran_on_device(events: Iterable) -> Dict[str, int]:
    """This package's kernels in a profiler's device events (objects
    with ``key``, the kernel's name, and ``count``, its runs), by device
    kernel, as :func:`device_kernel_counts` names them."""
    out: Dict[str, int] = {}
    for e in events:
        for k in set(DEVICE_KERNEL.values()):
            if re.search(k, e.key):
                out[k] = out.get(k, 0) + e.count
    return out
