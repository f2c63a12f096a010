"""Flush executors of the PiM op queue's kinds.

The port's counterpart of the JAX face of the JAX package's
``core/op_registry.py``, restricted to this slice's kinds:

* ``page_copy`` — RowClone copy (CoW forks), one batched launch per
  arena for the whole pending batch;
* ``page_init`` — RowClone-Init (init-on-free), one launch per arena per
  distinct fill value;
* ``kv_write`` — token KV slot writes, one scatter launch per arena.

A flush executor is ``(queue, arenas, ops) -> arenas``: it updates the
arenas in place and counts its launches on the queue.  The Ambit,
D-RaNGe and SSM-state kinds come with their slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch.kernels.rowclone import ops as rc_ops


@dataclass
class KVWriteBatch:
    """Pending slot writes: full-depth K/V for a batch of tokens, kept
    stacked as (layers, batch, ...) so enqueue and flush do O(1) host
    work in the batch size."""

    pages: List[int]
    slots: List[int]
    k: torch.Tensor      # (layers, batch, kvh, hd)
    v: torch.Tensor

    @property
    def n(self) -> int:
        return len(self.pages)


def _flush_page_copy(q, arenas, ops):
    src = [s for s, _ in ops]
    dst = [d for _, d in ops]
    for a in arenas:
        rc_ops.pim_page_copy_batched(a, src, dst)
    q._count_launch("page_copy", len(arenas))
    return arenas


def group_inits_by_value(ops) -> Dict[float, List[int]]:
    """(page, value) records -> {value: pages}: one launch per distinct
    fill value."""
    by_value: Dict[float, List[int]] = {}
    for page, value in ops:
        by_value.setdefault(value, []).append(page)
    return by_value


def _flush_page_init(q, arenas, ops):
    for value, pages in group_inits_by_value(ops).items():
        for a in arenas:
            rc_ops.pim_page_init_batched(a, pages, value)
        q._count_launch("page_init", len(arenas))
    return arenas


def last_writer(pages: List[int], slots: List[int]) -> np.ndarray:
    """Indices of the writes that survive when duplicate (page, slot)
    destinations resolve to the last one enqueued, in enqueue order."""
    seen = set()
    keep = []
    for i in range(len(pages) - 1, -1, -1):
        key = (pages[i], slots[i])
        if key not in seen:
            seen.add(key)
            keep.append(i)
    return np.asarray(keep[::-1], np.int64)


def _flush_kv_write(q, arenas, ops: List[KVWriteBatch]):
    if len(arenas) != 2:
        raise ValueError("kv_write flushes a (k, v) arena pair")
    k_arena, v_arena = arenas
    pages = [p for o in ops for p in o.pages]
    slots = [s for o in ops for s in o.slots]
    if len(ops) == 1:              # the common case: already stacked
        k_new, v_new = ops[0].k, ops[0].v
    else:
        k_new = torch.cat([o.k for o in ops], dim=1)   # (L, B, ...)
        v_new = torch.cat([o.v for o in ops], dim=1)
    # the queue promises that the last enqueued write to a slot wins; a
    # parallel scatter does not, so resolve duplicates here
    keep = last_writer(pages, slots)
    if keep.size != len(pages):
        pages = [pages[i] for i in keep]
        slots = [slots[i] for i in keep]
        idx = torch.from_numpy(keep).to(k_new.device)
        k_new, v_new = k_new[:, idx], v_new[:, idx]
    dev = k_arena.device
    pages_t = torch.tensor(pages, dtype=torch.int32, device=dev)
    slots_t = torch.tensor(slots, dtype=torch.int32, device=dev)
    rc_ops.kv_scatter_inline(k_arena, pages_t, slots_t,
                             k_new.to(device=dev, dtype=k_arena.dtype))
    rc_ops.kv_scatter_inline(v_arena, pages_t, slots_t,
                             v_new.to(device=dev, dtype=v_arena.dtype))
    q._count_launch("kv_write", 2)
    return arenas


#: kind -> flush executor, registered on every new queue in this order
QUEUE_KINDS: Dict[str, Callable] = {
    "page_copy": _flush_page_copy,
    "page_init": _flush_page_init,
    "kv_write": _flush_kv_write,
}
