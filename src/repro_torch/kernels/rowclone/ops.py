"""Wrappers for the RowClone kernels (``csrc/rowclone.cu``).

The port's counterpart of the JAX package's ``kernels/rowclone/ops.py``:
the public RowClone API (``pim_copy``, ``pim_init``, ``pim_page_copy``,
``pim_page_init``), the layer-batched ``pim_page_copy_batched`` and
``pim_page_init_batched`` (and ``pim_page_init_batched_pair``, one
launch for a (K, V) arena pair), and ``kv_scatter_inline`` /
``kv_scatter_pair_inline`` / ``kv_gather_inline``.  The JAX versions
donate the arena and return the new one; these update the arena in
place and return it.  On a CPU
tensor (or ``device="cpu"`` for ``pim_init``) each runs its plain
version in :mod:`.ref`; on a CUDA tensor it launches the kernel or
raises.  Arenas may carry any trailing dims: ``(P, ...)`` for the page
ops, ``(L, P, ...)`` for their batched forms and ``(L, P, S, ...)`` for
slot scatters.  An empty op batch launches nothing.

Host page lists reach the card through :func:`upload_index`: checked on
the host, staged in pinned memory and copied without a synchronise, so
no wrapper waits for the card (and a CUDA-graph capture can run beside
them).  The init launches skip even that for lists of up to
:data:`INLINE_ROWS` pages, which travel in the launch's parameters.
The slot scatters take int32 indices already on the device and convert
nothing: a wrong dtype, device or layout raises.
"""

from __future__ import annotations

import functools
import math
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
    return np.ascontiguousarray(np.asarray(idx, np.int32).reshape(-1))


def _row_bytes(arena: torch.Tensor, lead: int) -> int:
    return math.prod(arena.shape[lead:]) * arena.element_size()


def _check_arena(arena: torch.Tensor) -> None:
    if not arena.is_contiguous():
        raise ValueError("arena must be contiguous")


def _check_rows(idx: np.ndarray, limit: int, what: str) -> None:
    if idx.size and (idx.min() < 0 or idx.max() >= limit):
        raise IndexError(f"{what} out of range [0, {limit})")


def _stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s device."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without a synchronise: the copy goes
    through pinned memory with ``non_blocking=True``, so it queues
    behind the work already enqueued instead of waiting for it to finish
    (a copy from pageable memory would).  The caching host allocator
    records the copy on the pinned block and hands the block out again
    only after the copy ran.  On the CPU the array itself, as a
    tensor."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def upload_index(idx: Index, limit: int, what: str,
                 device: torch.device) -> torch.Tensor:
    """Host indices as an int32 tensor on ``device``, each checked to lie
    in ``[0, limit)`` on the host first (``IndexError`` otherwise), then
    uploaded by :func:`upload`."""
    a = _host_index(idx)
    _check_rows(a, limit, what)
    return upload(a, device)


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
    src_d = upload_index(src, P, "src page", arena.device)
    dst_d = upload_index(dst, P, "dst page", arena.device)
    if arena.device.type == "cpu":
        return ref.page_copy_batched(arena, src_d, dst_d)
    _check_arena(arena)
    lib = _build.load("rowclone")
    row = _row_bytes(arena, 2)
    n = int(src.size)
    stream = _stream(arena)
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


#: page lists up to this long travel in an init launch's parameters
#: (``kInlineRows`` in ``csrc/rowclone.cu``); longer ones are uploaded
INLINE_ROWS = 512


def _launch_init(arenas, dst: np.ndarray, rows: int, layers: int,
                 row_bytes: int, value, name: str) -> None:
    """One ``rc_init_rows`` launch over one arena or two of one shape:
    ``arena[l, dst[i]] <- value`` for every layer ``l`` of each arena,
    the page list in the launch's parameters when it is short, else
    uploaded by :func:`upload`."""
    a0 = arenas[0]
    dev_idx, host_idx = None, dst.tobytes()
    if dst.size > INLINE_ROWS:
        # freed after the launch; the allocator reuses it only for work
        # queued behind the launch on the same stream
        staged = upload(dst, a0.device)
        dev_idx, host_idx = staged.data_ptr(), None
    _build.check(_build.load("rowclone").rc_init_rows(
        a0.data_ptr(), arenas[-1].data_ptr(), len(arenas), dev_idx,
        host_idx, rows, int(dst.size), layers, row_bytes,
        fill_pattern(value, a0.dtype), _stream(a0)), name)
    count_launch(name)


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
    _launch_init((arena,), dst, P, L, _row_bytes(arena, 2), value,
                 "page_init_batched")
    return arena


def pim_page_init_batched_pair(k_arena: torch.Tensor, v_arena: torch.Tensor,
                               dst_pages: Index, value) -> None:
    """``pim_page_init_batched`` on both arenas of a (K, V) pair of one
    shape and dtype, in one launch (grid z picks the arena)."""
    if k_arena.shape != v_arena.shape or k_arena.dtype != v_arena.dtype \
            or k_arena.device != v_arena.device:
        raise ValueError("the pair's arenas differ in shape, dtype or "
                         "device")
    dst = _host_index(dst_pages)
    if dst.size == 0:
        return
    L, P = k_arena.shape[:2]
    _check_rows(dst, P, "dst page")
    if k_arena.device.type == "cpu":
        ref.page_init_batched_pair(k_arena, v_arena, torch.from_numpy(dst),
                                   value)
        return
    _check_arena(k_arena)
    _check_arena(v_arena)
    _launch_init((k_arena, v_arena), dst, P, L, _row_bytes(k_arena, 2),
                 value, "page_init_batched")


def _check_cuda(t: torch.Tensor, what: str) -> None:
    if not t.is_cuda:
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
    src_d = upload(src, arena.device)
    dst_d = upload(dst, arena.device)
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
    _launch_init((arena,), dst, P, 1, _row_bytes(arena, 1), value,
                 "page_init")
    return arena


def _check_scatter(arena: torch.Tensor, pages: torch.Tensor,
                   slots: torch.Tensor, new: torch.Tensor) -> None:
    """A slot scatter's operands as the kernel takes them, or raise:
    arena (L, P, S, ...) and new (L, B, ...) of one dtype with equal
    slot rows, pages/slots (B,) int32, all contiguous on one device."""
    L, B = arena.shape[0], pages.shape[0]
    if new.shape[:2] != (L, B) or slots.shape != pages.shape \
            or new.numel() != L * B * arena.stride(2):
        raise ValueError(f"new {tuple(new.shape)} does not match arena "
                         f"{tuple(arena.shape)} and {B} slots")
    if new.dtype != arena.dtype or pages.dtype != torch.int32 \
            or slots.dtype != torch.int32:
        raise TypeError("new must have the arena's dtype and pages/slots "
                        "must be int32")
    if not (arena.is_contiguous() and new.is_contiguous()
            and pages.is_contiguous() and slots.is_contiguous()):
        raise ValueError("arena, new, pages and slots must be contiguous")
    dev = arena.get_device()
    if new.get_device() != dev or pages.get_device() != dev \
            or slots.get_device() != dev:
        raise ValueError("arena, new, pages and slots must share a device")


def kv_scatter_inline(arena: torch.Tensor, pages: torch.Tensor,
                      slots: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """``arena[:, pages[b], slots[b]] <- new[:, b]`` across every layer in
    one launch, in place.  arena: (L, P, S, ...); new: (L, B, ...) of the
    arena's dtype; pages/slots: (B,) int32 on the arena's device; all
    contiguous (see :func:`_check_scatter`; nothing is converted).
    Duplicate (page, slot) pairs must carry identical payloads (batch
    pad rows); the op queue resolves real duplicates before it calls
    this."""
    B = pages.shape[0]
    if B == 0:
        return arena
    _check_scatter(arena, pages, slots, new)
    L, P, S = arena.shape[:3]
    if arena.device.type == "cpu":
        ref.kv_scatter(arena.view(L, P, S, -1), pages, slots,
                       new.view(L, B, -1))
        return arena
    _launch_scatter((arena,), (new,), pages, slots)
    return arena


def kv_scatter_pair_inline(k_arena: torch.Tensor, v_arena: torch.Tensor,
                           pages: torch.Tensor, slots: torch.Tensor,
                           k_new: torch.Tensor, v_new: torch.Tensor) -> None:
    """:func:`kv_scatter_inline` on a (K, V) arena pair of one shape with
    one index list, in one launch (counted once as ``kv_scatter``)."""
    B = pages.shape[0]
    if B == 0:
        return
    if k_arena.shape != v_arena.shape:
        raise ValueError("the pair's arenas differ in shape")
    _check_scatter(k_arena, pages, slots, k_new)
    _check_scatter(v_arena, pages, slots, v_new)
    L, P, S = k_arena.shape[:3]
    if k_arena.device.type == "cpu":
        ref.kv_scatter_pair(k_arena.view(L, P, S, -1),
                            v_arena.view(L, P, S, -1), pages, slots,
                            k_new.view(L, B, -1), v_new.view(L, B, -1))
        return
    _launch_scatter((k_arena, v_arena), (k_new, v_new), pages, slots)


def _launch_scatter(arenas, news, pages: torch.Tensor,
                    slots: torch.Tensor) -> None:
    """One ``rc_kv_scatter`` launch over one arena or two of one shape
    (operands checked by :func:`_check_scatter`)."""
    a0 = arenas[0]
    L, P, S = a0.shape[:3]
    _build.check(_build.load("rowclone").rc_kv_scatter(
        a0.data_ptr(), arenas[-1].data_ptr(), news[0].data_ptr(),
        news[-1].data_ptr(), len(arenas), pages.data_ptr(), slots.data_ptr(),
        L, pages.shape[0], P, S, a0.stride(2) * a0.element_size(),
        _stream(a0)), "kv_scatter")
    count_launch("kv_scatter")


def kv_gather_inline(arena: torch.Tensor, pages: torch.Tensor,
                     slots: torch.Tensor) -> torch.Tensor:
    """``arena[:, pages[b], slots[b]]`` -> (L, B, ...).  Reads have no
    kernel of their own (the JAX package has none either)."""
    return ref.kv_gather(arena, pages, slots)
