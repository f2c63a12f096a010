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

from typing import Dict

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
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def count_launch(name: str, n: int = 1) -> None:
    LAUNCHES[name] += n
