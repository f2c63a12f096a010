"""Wrappers for the Ambit kernels (``csrc/ambit.cu``).

The port's counterpart of the JAX package's ``kernels/ambit/ops.py``:
``pim_page_bitwise_batched`` (AND, OR and NOT) and
``pim_page_bitwise_batched_pair`` (one op list on both arenas of a
pair, in one launch), ``pim_page_zero_scan``, and
``pim_page_zero_scan_pair``, the scan of a (K, V) pair in one launch
whose flags come back to the host.  The ops are defined on bit
patterns, so any dtype works and a float arena is never converted.  The
JAX versions donate the arena and return the new one; these update it
in place.  On a CPU tensor each runs its plain version in :mod:`.ref`;
on a CUDA tensor it launches the kernel or raises.  Launches count
under ``page_bitwise_batched`` (AND, OR), ``page_not_batched`` (NOT)
and ``page_zero_scan`` (one a scan, pair or single).  A bitwise op list
of up to :data:`~repro_torch.kernels.rowclone.ops.INLINE_PAIRS` ops and
a scan's page list of up to
:data:`~repro_torch.kernels.rowclone.ops.INLINE_ROWS` pages travel in
the launch's parameters; longer ones are uploaded.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.rowclone.ops import (INLINE_ROWS, Index,
                                              _check_arena, _check_cuda,
                                              _check_rows, _host_index,
                                              _int_list, _row_bytes,
                                              _stream, launch_rows, upload)
from . import ref

_OP_CODE = {"and": 0, "or": 1, "not": 2}
_COPY = 3                  # the staged route's gather
_MAX_GRID = 65535          # the scan's grid y (pages)


def _bitwise_ops(src_pages: Index, dst_pages: Index, limit: int,
                 op: str) -> Tuple[List[int], List[int]]:
    """A bitwise batch's page lists as host ints, each checked to lie in
    ``[0, limit)`` (``IndexError``); lists of two lengths, an unknown op
    and a repeated destination raise ``ValueError`` (the op queue
    flushes before a second op on one page)."""
    if op not in _OP_CODE:
        raise ValueError(f"unknown ambit bitwise op {op!r}")
    src, dst = _int_list(src_pages), _int_list(dst_pages)
    if len(src) != len(dst):
        raise ValueError("src and dst page lists differ in length")
    if not src:
        return src, dst
    for what, rows in (("src page", src), ("dst page", dst)):
        if min(rows) < 0 or max(rows) >= limit:
            raise IndexError(f"{what} out of range [0, {limit})")
    if len(set(dst)) != len(dst):
        raise ValueError("an ambit batch writes one page at most once")
    return src, dst


def _plain(arena: torch.Tensor, src: List[int], dst: List[int],
           op: str) -> torch.Tensor:
    s, d = torch.tensor(src), torch.tensor(dst)
    if op == "not":
        return ref.page_not_batched(arena, s, d)
    return ref.page_bitwise_batched(arena, s, d, op)


def _launch_bitwise(arenas, src: List[int], dst: List[int], op: str) -> str:
    """One ``am_page_rows`` launch of ``op`` over one arena or a pair
    (two on the staged route, :func:`~repro_torch.kernels.rowclone.ops.
    launch_rows`).  Returns the route."""
    lib = _build.load("ambit")
    stream = _stream(arenas[0])
    code = _OP_CODE[op]
    name = "page_not_batched" if op == "not" else "page_bitwise_batched"
    return launch_rows(
        arenas, 2, src, dst, name,
        lambda *args: lib.am_page_rows(*args[:-1],
                                       _COPY if args[-1] else code, stream),
        cluster_chunks)


@functools.lru_cache(maxsize=None)
def cluster_chunks() -> int:
    """The most 16 KiB chunks of one layer's batch that the bitwise ops'
    cluster route stages in shared memory (``am_cluster_chunks``)."""
    return _build.load("ambit").am_cluster_chunks()


def pim_page_bitwise_batched(arena: torch.Tensor, src_pages: Index,
                             dst_pages: Index, *, op: str) -> torch.Tensor:
    """``arena[:, dst[i]] <- arena[:, src[i]] OP arena[:, dst[i]]`` for op
    in {"and", "or"}, or ``<- ~arena[:, src[i]]`` for "not", across every
    layer of an ``(L, P, ...)`` arena, in place.  Every op reads the
    pre-batch arena: the page lists are host data, so the wrapper sees
    when a destination is another op's source and then takes the
    kernel's cluster route (:func:`~repro_torch.kernels.rowclone.ops.
    copy_route`).  Destinations are distinct."""
    src, dst = _bitwise_ops(src_pages, dst_pages, arena.shape[1], op)
    if not src:
        return arena
    if arena.device.type == "cpu":
        return _plain(arena, src, dst, op)
    _check_cuda(arena, "pim_page_bitwise_batched")
    _launch_bitwise((arena,), src, dst, op)
    return arena


def pim_page_bitwise_batched_pair(a0: torch.Tensor, a1: torch.Tensor,
                                  src_pages: Index, dst_pages: Index, *,
                                  op: str) -> None:
    """:func:`pim_page_bitwise_batched` with one op list on both arenas
    of a pair (each ``(L, P, ...)``, shapes and dtypes may differ; the
    pages must lie in both), in one launch counted once."""
    if a0.device != a1.device:
        raise ValueError("the pair's arenas lie on different devices")
    src, dst = _bitwise_ops(src_pages, dst_pages,
                            min(a0.shape[1], a1.shape[1]), op)
    if not src:
        return
    if a0.device.type == "cpu":
        _plain(a0, src, dst, op)
        _plain(a1, src, dst, op)
        return
    _check_cuda(a0, "pim_page_bitwise_batched_pair")
    _check_cuda(a1, "pim_page_bitwise_batched_pair")
    _launch_bitwise((a0, a1), src, dst, op)


def pim_page_zero_scan(arena: torch.Tensor, pages: Index) -> torch.Tensor:
    """Per-page zero-compare on bits: bool (n,) on the arena's device,
    True where ``arena[:, pages[i]]`` is all-zero bits in every layer
    (a bf16 ``-0.0`` is a nonzero bit).  Read-only; one launch, which
    writes the bools itself, and no wait for the card."""
    idx = _host_index(pages)
    if idx.size == 0:
        return torch.zeros((0,), dtype=torch.bool, device=arena.device)
    L, P = arena.shape[:2]
    _check_rows(idx, P, "page")
    if arena.device.type == "cpu":
        return ref.page_zero_scan(arena, torch.from_numpy(idx))
    _check_arena(arena)
    out = torch.empty((idx.size,), dtype=torch.bool, device=arena.device)
    _launch_scan((arena,), idx, out.data_ptr(), None)
    return out


def pim_page_zero_scan_pair(k_arena: torch.Tensor, v_arena: torch.Tensor,
                            pages: Index) -> np.ndarray:
    """The zero-compare of a (K, V) pair of one shape and dtype: bool
    (n,) on the host, True where page ``pages[i]`` is all-zero bits in
    every layer of both arenas.  One launch over the pair (grid z picks
    the arena), which writes the flags into mapped pinned host memory,
    then one wait for the card before they are read."""
    if k_arena.shape != v_arena.shape or k_arena.dtype != v_arena.dtype \
            or k_arena.device != v_arena.device:
        raise ValueError("the pair's arenas differ in shape, dtype or "
                         "device")
    idx = _host_index(pages)
    if idx.size == 0:
        return np.zeros((0,), bool)
    L, P = k_arena.shape[:2]
    _check_rows(idx, P, "page")
    if k_arena.device.type == "cpu":
        return ref.page_zero_scan_pair(k_arena, v_arena,
                                       torch.from_numpy(idx)).numpy()
    _check_arena(k_arena)
    _check_arena(v_arena)
    with _HOST_FLAGS.lock:
        flags = _HOST_FLAGS.get(idx.size)
        stream = _launch_scan((k_arena, v_arena), idx, None,
                              flags.ctypes.data)
        # the kernel's writes to mapped memory are visible once it ends
        _build.check(_build.load("ambit").am_stream_wait(stream),
                     "page_zero_scan (wait)")
        return flags[:idx.size].astype(bool)


#: (device index, raw stream) -> the scan's device scratch: a counter of
#: finished blocks and one word a page, zero between launches (each
#: launch's last block zeroes what it used)
_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}


class _MappedFlags:
    """The pair scan's host flags: pinned host memory mapped into the
    card's address space, allocated at first use and grown on demand;
    the lock keeps one scan at a time on it."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.ptr = None
        self.flags = np.zeros((0,), np.uint8)

    def get(self, n: int) -> np.ndarray:
        if n > self.flags.size:
            lib = _build.load("ambit")
            if self.ptr is not None:
                _build.check(lib.am_free_mapped(self.ptr), "page_zero_scan "
                             "(free host flags)")
                self.ptr, self.flags = None, np.zeros((0,), np.uint8)
            cap = max(n, 2 * INLINE_ROWS)
            ptr = ctypes.c_void_p()
            _build.check(lib.am_alloc_mapped(cap, ctypes.byref(ptr)),
                         "page_zero_scan (host flags)")
            self.ptr = ptr.value
            self.flags = np.ctypeslib.as_array(
                (ctypes.c_ubyte * cap).from_address(self.ptr))
        return self.flags


_HOST_FLAGS = _MappedFlags()


def _scratch(arena: torch.Tensor, stream: int, n: int) -> torch.Tensor:
    key = (arena.get_device(), stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < n + 1:
        # zeroed once here; every launch leaves it zero
        buf = torch.zeros((max(n, INLINE_ROWS) + 1,), dtype=torch.int32,
                          device=arena.device)
        _SCRATCH[key] = buf
    return buf


def _launch_scan(arenas, idx: np.ndarray, out_dev, out_host) -> int:
    """One ``am_zero_scan`` launch over one arena or a pair of one shape
    (pages checked by the caller), counted once.  Returns the stream."""
    a0 = arenas[0]
    L, P = a0.shape[:2]
    n = int(idx.size)
    if n > _MAX_GRID:
        raise ValueError(f"{n} pages: a scan takes at most {_MAX_GRID}")
    dev_idx, host_idx = None, idx.ctypes.data
    if n > INLINE_ROWS:
        # freed after the launch; the allocator reuses it only for work
        # queued behind the launch on the same stream
        staged = upload(idx, a0.device)
        dev_idx, host_idx = staged.data_ptr(), None
    stream = _stream(a0)
    _build.check(_build.load("ambit").am_zero_scan(
        a0.data_ptr(), arenas[-1].data_ptr(), len(arenas), dev_idx, host_idx,
        P, n, L, _row_bytes(a0, 2), _scratch(a0, stream, n).data_ptr(),
        out_dev, out_host, stream), "page_zero_scan")
    count_launch("page_zero_scan")
    return stream
