"""Plain PyTorch versions of the Ambit kernels (the JAX package's
``kernels/ambit/ref.py``), on the arena's bits.

The JAX wrappers bitcast a float arena to an unsigned view before the
op; torch on the CPU has little unsigned 16- and 32-bit support, so
these view it as the signed integer of the same width instead: AND, OR,
NOT and ``!= 0`` give the same bits on a signed view.  They are what the
wrappers in :mod:`.ops` run on CPU tensors, and what the kernels are
held against on the card.  The ops update the arena in place.
"""

from __future__ import annotations

import torch

_SIGNED = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_OPS = {"and": torch.bitwise_and, "or": torch.bitwise_or}


def bits(arena: torch.Tensor) -> torch.Tensor:
    """An integer view of the arena's bits (the same storage)."""
    if arena.dtype in (torch.uint8, torch.int8, torch.int16, torch.int32,
                       torch.int64):
        return arena
    return arena.view(_SIGNED[arena.element_size()])


def page_bitwise_batched(arena: torch.Tensor, src_pages: torch.Tensor,
                         dst_pages: torch.Tensor, op: str) -> torch.Tensor:
    """arena: (L, P, ...); ``dst[i] <- src[i] OP dst[i]`` for op in
    {"and", "or"}, every operand read before any destination is
    written."""
    b = bits(arena)
    s, d = src_pages.long(), dst_pages.long()
    b[:, d] = _OPS[op](b[:, s], b[:, d])
    return arena


def page_not_batched(arena: torch.Tensor, src_pages: torch.Tensor,
                     dst_pages: torch.Tensor) -> torch.Tensor:
    b = bits(arena)
    b[:, dst_pages.long()] = torch.bitwise_not(b[:, src_pages.long()])
    return arena


def page_zero_scan(arena: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """Bool (n,): True where the page holds all-zero bits in every
    layer."""
    sel = bits(arena)[:, pages.long()]                  # (L, n, ...)
    return ~(sel != 0).transpose(0, 1).reshape(len(pages), -1).any(dim=1)


def page_zero_scan_pair(k_arena: torch.Tensor, v_arena: torch.Tensor,
                        pages: torch.Tensor) -> torch.Tensor:
    """Bool (n,): True where the page holds all-zero bits in every layer
    of both arenas."""
    return page_zero_scan(k_arena, pages) & page_zero_scan(v_arena, pages)
