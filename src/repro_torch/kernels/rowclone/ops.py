"""Wrappers for the RowClone kernels (``csrc/rowclone.cu``).

The port's counterpart of the JAX package's ``kernels/rowclone/ops.py``:
``pim_page_copy_batched``, ``pim_page_init_batched``,
``kv_scatter_inline`` and ``kv_gather_inline``.  The JAX versions
donate the arena and return the new one; these update the arena in
place and return it.  On a CPU tensor each runs its plain version in
:mod:`.ref`; on a CUDA tensor it launches the kernel or raises.
Arenas may carry any trailing dims: ``(L, P, ...)`` for page ops and
``(L, P, S, ...)`` for slot scatters.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from repro_torch.kernels import _build, count_launch
from . import ref

Index = Union[Sequence[int], np.ndarray, torch.Tensor]


def _host_index(idx: Index) -> np.ndarray:
    if isinstance(idx, torch.Tensor):
        idx = idx.detach().cpu().numpy()
    return np.asarray(idx, np.int32).reshape(-1)


def _row_bytes(arena: torch.Tensor, lead: int) -> int:
    return int(np.prod(arena.shape[lead:], dtype=np.int64)) \
        * arena.element_size()


def _check_arena(arena: torch.Tensor) -> None:
    if not arena.is_contiguous():
        raise ValueError("arena must be contiguous")


def _check_rows(idx: np.ndarray, limit: int, what: str) -> None:
    if idx.size and (idx.min() < 0 or idx.max() >= limit):
        raise IndexError(f"{what} out of range [0, {limit})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def pim_page_copy_batched(arena: torch.Tensor, src_pages: Index,
                          dst_pages: Index) -> torch.Tensor:
    """``arena[:, dst[i]] <- arena[:, src[i]]`` across every layer, in
    place.  The page lists are host data (the op queue's records), so
    the wrapper sees on the host whether a destination is also a source;
    only then does it stage the sources through a scratch buffer (one
    gather launch, one scatter launch), so every copy reads the
    pre-batch arena as the reference does."""
    src = _host_index(src_pages)
    dst = _host_index(dst_pages)
    if src.size != dst.size:
        raise ValueError("src and dst page lists differ in length")
    if src.size == 0:
        return arena
    L, P = arena.shape[:2]
    _check_rows(src, P, "src page")
    _check_rows(dst, P, "dst page")
    if arena.device.type == "cpu":
        return ref.page_copy_batched(arena, torch.from_numpy(src),
                                     torch.from_numpy(dst))
    _check_arena(arena)
    lib = _build.load("rowclone")
    row = _row_bytes(arena, 2)
    n = int(src.size)
    stream = _stream(arena)
    src_d = torch.from_numpy(src).to(arena.device)
    dst_d = torch.from_numpy(dst).to(arena.device)
    if np.intersect1d(src, dst).size == 0:
        _build.check(lib.rc_copy_rows(
            arena.data_ptr(), src_d.data_ptr(), P, arena.data_ptr(),
            dst_d.data_ptr(), P, n, L, row, stream), "page_copy_batched")
        count_launch("page_copy_batched")
        return arena
    scratch = torch.empty((L, n) + tuple(arena.shape[2:]), dtype=arena.dtype,
                          device=arena.device)
    _build.check(lib.rc_copy_rows(
        arena.data_ptr(), src_d.data_ptr(), P, scratch.data_ptr(), None, n,
        n, L, row, stream), "page_copy_batched (gather)")
    _build.check(lib.rc_copy_rows(
        scratch.data_ptr(), None, n, arena.data_ptr(), dst_d.data_ptr(), P,
        n, L, row, stream), "page_copy_batched (scatter)")
    count_launch("page_copy_batched", 2)
    return arena


def fill_pattern(value, dtype: torch.dtype) -> int:
    """The 32-bit word that repeats ``value``'s bit pattern in ``dtype``
    (the init kernel writes whole words)."""
    raw = torch.tensor([value], dtype=dtype).view(torch.uint8).numpy()
    if raw.size not in (1, 2, 4):
        raise TypeError(f"page init supports 1-, 2- and 4-byte dtypes, "
                        f"not {dtype}")
    word = np.tile(raw, 4 // raw.size)
    return int(word.view(np.uint32)[0])


def pim_page_init_batched(arena: torch.Tensor, dst_pages: Index,
                          value) -> torch.Tensor:
    """``arena[:, dst[i]] <- value`` across every layer, in place."""
    dst = _host_index(dst_pages)
    if dst.size == 0:
        return arena
    L, P = arena.shape[:2]
    _check_rows(dst, P, "dst page")
    if arena.device.type == "cpu":
        return ref.page_init_batched(arena, torch.from_numpy(dst), value)
    _check_arena(arena)
    row = _row_bytes(arena, 2)
    if row % 4:
        raise ValueError("page rows must be a multiple of 4 bytes")
    pattern = fill_pattern(value, arena.dtype)
    lib = _build.load("rowclone")
    dst_d = torch.from_numpy(dst).to(arena.device)
    _build.check(lib.rc_init_rows(
        arena.data_ptr(), dst_d.data_ptr(), P, int(dst.size), L, row,
        pattern, _stream(arena)), "page_init_batched")
    count_launch("page_init_batched")
    return arena


def kv_scatter_inline(arena: torch.Tensor, pages: torch.Tensor,
                      slots: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """``arena[:, pages[b], slots[b]] <- new[:, b]`` across every layer in
    one launch, in place.  arena: (L, P, S, ...); new: (L, B, ...);
    pages/slots: (B,) int on the arena's device.  Duplicate (page, slot)
    pairs must carry identical payloads (batch pad rows); the op queue
    resolves real duplicates before it calls this."""
    B = pages.shape[0]
    if B == 0:
        return arena
    L, P, S = arena.shape[:3]
    if new.shape[:2] != (L, B) or slots.shape[0] != B:
        raise ValueError(f"new {tuple(new.shape)} does not match arena "
                         f"{tuple(arena.shape)} and {B} slots")
    if arena.device.type == "cpu":
        a4 = arena.view(L, P, S, -1)
        ref.kv_scatter(a4, pages, slots, new.reshape(L, B, -1))
        return arena
    _check_arena(arena)
    if new.device != arena.device or pages.device != arena.device \
            or slots.device != arena.device:
        raise ValueError("arena, new, pages and slots must share a device")
    new = new.to(arena.dtype).contiguous()
    if new.numel() != L * B * (arena.numel() // (L * P * S)):
        raise ValueError("new's trailing dims do not match the arena's")
    pages = pages.to(torch.int32).contiguous()
    slots = slots.to(torch.int32).contiguous()
    lib = _build.load("rowclone")
    _build.check(lib.rc_kv_scatter(
        arena.data_ptr(), new.data_ptr(), pages.data_ptr(), slots.data_ptr(),
        L, B, P, S, _row_bytes(arena, 3), _stream(arena)), "kv_scatter")
    count_launch("kv_scatter")
    return arena


def kv_gather_inline(arena: torch.Tensor, pages: torch.Tensor,
                     slots: torch.Tensor) -> torch.Tensor:
    """``arena[:, pages[b], slots[b]]`` -> (L, B, ...).  Reads have no
    kernel of their own (the JAX package has none either)."""
    return ref.kv_gather(arena, pages, slots)
