"""Plain PyTorch versions of the RowClone kernels (the JAX package's
``kernels/rowclone/ref.py``), updating the arena in place.

They are what the wrappers in :mod:`.ops` run on CPU tensors, and what
the kernels are held against on the card.
"""

from __future__ import annotations

from typing import List

import torch


def copy_2d(src: torch.Tensor) -> torch.Tensor:
    """A fresh buffer holding ``src``'s values."""
    return src.clone()


def init_2d(shape, value, dtype: torch.dtype = torch.float32,
            device=None) -> torch.Tensor:
    """A fresh ``shape`` buffer of ``value`` in ``dtype`` (rounded and
    cast as ``torch.tensor([value], dtype=dtype)`` casts it)."""
    fill = torch.tensor([value], dtype=dtype)
    return fill.to(device).expand(tuple(shape)).clone()


def last_op_per_dst(dst_pages: List[int]) -> List[int]:
    """Indices of the ops that survive when duplicate destinations
    resolve to the last op, in op order."""
    return sorted({d: i for i, d in enumerate(dst_pages)}.values())


def _last_ops(src_pages: torch.Tensor, dst_pages: torch.Tensor):
    """The (src, dst) index tensors of the ops that survive
    :func:`last_op_per_dst` (``index_put`` with duplicate indices has no
    defined order, so they are resolved here)."""
    keep = torch.tensor(last_op_per_dst(dst_pages.tolist()),
                        device=dst_pages.device)
    return src_pages.long()[keep], dst_pages.long()[keep]


def page_copy(arena: torch.Tensor, src_pages: torch.Tensor,
              dst_pages: torch.Tensor) -> torch.Tensor:
    """``arena[dst[i]] <- arena[src[i]]`` on a (pages, ...) arena: every
    source is read before any destination is written, and of several
    ops with one destination the last wins."""
    src, dst = _last_ops(src_pages, dst_pages)
    arena[dst] = arena[src]
    return arena


def page_init(arena: torch.Tensor, dst_pages: torch.Tensor,
              value) -> torch.Tensor:
    """``arena[dst[i]] <- value`` on a (pages, ...) arena."""
    arena[dst_pages.long()] = torch.tensor(value, dtype=arena.dtype)
    return arena


def page_copy_batched(arena: torch.Tensor, src_pages: torch.Tensor,
                      dst_pages: torch.Tensor) -> torch.Tensor:
    """``arena[:, dst[i]] <- arena[:, src[i]]``; every source is read
    (gathered into a copy) before any destination is written, and of
    several ops with one destination the last wins."""
    src, dst = _last_ops(src_pages, dst_pages)
    arena[:, dst] = arena[:, src]
    return arena


def page_copy_batched_pair(a0: torch.Tensor, a1: torch.Tensor,
                           src_pages: torch.Tensor,
                           dst_pages: torch.Tensor) -> None:
    """``page_copy_batched`` on both arenas of a pair, one op list."""
    page_copy_batched(a0, src_pages, dst_pages)
    page_copy_batched(a1, src_pages, dst_pages)


def page_init_batched(arena: torch.Tensor, dst_pages: torch.Tensor,
                      value) -> torch.Tensor:
    arena[:, dst_pages.long()] = torch.tensor(value, dtype=arena.dtype)
    return arena


def page_init_batched_pair(k_arena: torch.Tensor, v_arena: torch.Tensor,
                           dst_pages: torch.Tensor, value) -> None:
    """``page_init_batched`` on both arenas of a (K, V) pair."""
    page_init_batched(k_arena, dst_pages, value)
    page_init_batched(v_arena, dst_pages, value)


def kv_scatter(arena: torch.Tensor, pages: torch.Tensor, slots: torch.Tensor,
               new: torch.Tensor) -> torch.Tensor:
    """arena: (L, P, S, E); pages/slots: (B,); new: (L, B, E)."""
    arena[:, pages.long(), slots.long()] = new.to(arena.dtype)
    return arena


def kv_scatter_pair(k_arena: torch.Tensor, v_arena: torch.Tensor,
                    pages: torch.Tensor, slots: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor) -> None:
    """``kv_scatter`` on both arenas of a (K, V) pair, one index list."""
    kv_scatter(k_arena, pages, slots, k_new)
    kv_scatter(v_arena, pages, slots, v_new)


def kv_gather(arena: torch.Tensor, pages: torch.Tensor,
              slots: torch.Tensor) -> torch.Tensor:
    """``arena[:, pages[b], slots[b]]`` -> (L, B, E), the scatter's
    inverse."""
    return arena[:, pages.long(), slots.long()]
