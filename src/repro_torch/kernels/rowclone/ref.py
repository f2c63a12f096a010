"""Plain PyTorch versions of the RowClone kernels (the JAX package's
``kernels/rowclone/ref.py``), updating the arena in place.

They are what the wrappers in :mod:`.ops` run on CPU tensors, and what
the kernels are held against on the card.
"""

from __future__ import annotations

import torch


def page_copy_batched(arena: torch.Tensor, src_pages: torch.Tensor,
                      dst_pages: torch.Tensor) -> torch.Tensor:
    """``arena[:, dst[i]] <- arena[:, src[i]]``; every source is read
    (gathered into a copy) before any destination is written."""
    arena[:, dst_pages.long()] = arena[:, src_pages.long()]
    return arena


def page_init_batched(arena: torch.Tensor, dst_pages: torch.Tensor,
                      value) -> torch.Tensor:
    arena[:, dst_pages.long()] = torch.tensor(value, dtype=arena.dtype)
    return arena


def kv_scatter(arena: torch.Tensor, pages: torch.Tensor, slots: torch.Tensor,
               new: torch.Tensor) -> torch.Tensor:
    """arena: (L, P, S, E); pages/slots: (B,); new: (L, B, E)."""
    arena[:, pages.long(), slots.long()] = new.to(arena.dtype)
    return arena


def kv_gather(arena: torch.Tensor, pages: torch.Tensor,
              slots: torch.Tensor) -> torch.Tensor:
    """``arena[:, pages[b], slots[b]]`` -> (L, B, E), the scatter's
    inverse."""
    return arena[:, pages.long(), slots.long()]
