"""Wrappers for the RowClone kernels (``csrc/rowclone.cu``).

The port's counterpart of the JAX package's ``kernels/rowclone/ops.py``:
the public RowClone API (``pim_copy``, ``pim_init``, ``pim_page_copy``,
``pim_page_init``), the layer-batched ``pim_page_copy_batched`` and
``pim_page_init_batched``, and ``kv_scatter_inline`` /
``kv_gather_inline``.  The JAX versions donate the arena and return the
new one; these update the arena in place and return it.  On a CPU
tensor (or ``device="cpu"`` for ``pim_init``) each runs its plain
version in :mod:`.ref`; on a CUDA tensor it launches the kernel or
raises.  Arenas may carry any trailing dims: ``(P, ...)`` for the page
ops, ``(L, P, ...)`` for their batched forms and ``(L, P, S, ...)`` for
slot scatters.  An empty op batch launches nothing.
"""

from __future__ import annotations

import functools
from typing import Sequence, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
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
    (the init kernels write whole words; byte k of a row or buffer is
    byte k % 4 of the word).  ``value`` rounds and casts as
    ``torch.tensor([value], dtype=dtype)`` does (bf16 0.1 is 0.100098,
    int32 1.5 is 1).  Cached: the key carries ``repr(value)``, since
    ``-0.0 == 0.0`` but their bits differ."""
    return _fill_pattern(repr(value), value, dtype)


@functools.lru_cache(maxsize=256)
def _fill_pattern(key: str, value, dtype: torch.dtype) -> int:
    raw = torch.tensor([value], dtype=dtype).view(torch.uint8).numpy()
    if raw.size not in (1, 2, 4):
        raise TypeError(f"the fill kernels support 1-, 2- and 4-byte dtypes, "
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
    pattern = fill_pattern(value, arena.dtype)
    lib = _build.load("rowclone")
    dst_d = torch.from_numpy(dst).to(arena.device)
    _build.check(lib.rc_init_rows(
        arena.data_ptr(), dst_d.data_ptr(), P, int(dst.size), L,
        _row_bytes(arena, 2), pattern, _stream(arena)), "page_init_batched")
    count_launch("page_init_batched")
    return arena


def _check_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for a tensor on {t.device}")
    _check_arena(t)


def pim_copy(src: torch.Tensor) -> torch.Tensor:
    """A fresh copy of ``src`` (any shape and dtype): one streamed pass
    that reads ``src`` once and writes the copy once.  The JAX package
    reshapes other ranks to ``(shape[0], -1)`` for its 2D kernel; the
    kernel here moves the contiguous bytes, so every rank is one flat
    copy."""
    if src.device.type == "cpu":
        return ref.copy_2d(src)
    _check_cuda(src, "pim_copy")
    out = torch.empty_like(src, memory_format=torch.contiguous_format)
    nbytes = src.numel() * src.element_size()
    if nbytes == 0:
        return out
    lib = _build.load("rowclone")
    _build.check(lib.rc_copy_flat(src.data_ptr(), out.data_ptr(), nbytes,
                                  _stream(src)), "copy_2d")
    count_launch("copy_2d")
    return out


def pim_init(shape, value, dtype: torch.dtype = torch.float32, *,
             device: DeviceLike = None) -> torch.Tensor:
    """A fresh ``shape`` buffer of ``value`` in ``dtype`` on ``device``
    (None: the card): one write-only pass with no read of the old
    contents (the calloc-vs-RowClone-Init point).  1-, 2- and 4-byte
    dtypes; an 8-byte one raises ``TypeError``."""
    dev = resolve_device(device)
    shape = tuple(int(d) for d in shape)
    pattern = fill_pattern(value, dtype)
    if dev.type == "cpu":
        return ref.init_2d(shape, value, dtype)
    out = torch.empty(shape, dtype=dtype, device=dev)
    nbytes = out.numel() * out.element_size()
    if nbytes == 0:
        return out
    lib = _build.load("rowclone")
    _build.check(lib.rc_fill_flat(out.data_ptr(), nbytes, pattern,
                                  _stream(out)), "init_2d")
    count_launch("init_2d")
    return out


def pim_page_copy(arena: torch.Tensor, src_pages: Index,
                  dst_pages: Index) -> torch.Tensor:
    """``arena[dst[i]] <- arena[src[i]]`` on a ``(pages, ...)`` arena, in
    place.  Every copy reads the arena as it was before the batch, and
    of several ops with one destination the last wins (as the
    reference's scatter resolves them): the wrapper drops the earlier
    ones on the host, and stages the sources through scratch (a gather
    and a scatter launch) only when a destination is also a source."""
    src = _host_index(src_pages)
    dst = _host_index(dst_pages)
    if src.size != dst.size:
        raise ValueError("src and dst page lists differ in length")
    if src.size == 0:
        return arena
    P = arena.shape[0]
    _check_rows(src, P, "src page")
    _check_rows(dst, P, "dst page")
    if arena.device.type == "cpu":
        return ref.page_copy(arena, torch.from_numpy(src),
                             torch.from_numpy(dst))
    _check_cuda(arena, "pim_page_copy")
    keep = ref.last_op_per_dst(dst)
    src, dst = src[keep], dst[keep]
    lib = _build.load("rowclone")
    row = _row_bytes(arena, 1)
    n = int(src.size)
    stream = _stream(arena)
    src_d = torch.from_numpy(src).to(arena.device)
    dst_d = torch.from_numpy(dst).to(arena.device)
    if np.intersect1d(src, dst).size == 0:
        _build.check(lib.rc_copy_rows(
            arena.data_ptr(), src_d.data_ptr(), P, arena.data_ptr(),
            dst_d.data_ptr(), P, n, 1, row, stream), "page_copy")
        count_launch("page_copy")
        return arena
    scratch = torch.empty((n,) + tuple(arena.shape[1:]), dtype=arena.dtype,
                          device=arena.device)
    _build.check(lib.rc_copy_rows(
        arena.data_ptr(), src_d.data_ptr(), P, scratch.data_ptr(), None, n,
        n, 1, row, stream), "page_copy (gather)")
    _build.check(lib.rc_copy_rows(
        scratch.data_ptr(), None, n, arena.data_ptr(), dst_d.data_ptr(), P,
        n, 1, row, stream), "page_copy (scatter)")
    count_launch("page_copy", 2)
    return arena


def pim_page_init(arena: torch.Tensor, dst_pages: Index,
                  value) -> torch.Tensor:
    """``arena[dst[i]] <- value`` on a ``(pages, ...)`` arena, in place;
    the arena is never read.  Pages of any byte length (a row that is
    not a multiple of 4 bytes is written byte by byte)."""
    dst = _host_index(dst_pages)
    if dst.size == 0:
        return arena
    P = arena.shape[0]
    _check_rows(dst, P, "dst page")
    if arena.device.type == "cpu":
        return ref.page_init(arena, torch.from_numpy(dst), value)
    _check_cuda(arena, "pim_page_init")
    pattern = fill_pattern(value, arena.dtype)
    lib = _build.load("rowclone")
    dst_d = torch.from_numpy(dst).to(arena.device)
    _build.check(lib.rc_init_rows(
        arena.data_ptr(), dst_d.data_ptr(), P, int(dst.size), 1,
        _row_bytes(arena, 1), pattern, _stream(arena)), "page_init")
    count_launch("page_init")
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
