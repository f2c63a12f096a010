"""Wrappers for the Ambit kernels (``csrc/ambit.cu``).

The port's counterpart of the JAX package's ``kernels/ambit/ops.py``:
``pim_page_bitwise_batched`` (AND, OR and NOT) and
``pim_page_zero_scan``, and ``pim_page_zero_scan_pair``, the scan of
a (K, V) pair in one launch whose flags come back to the host.  The ops
are defined on bit patterns, so any dtype works and a float arena is
never converted.  The JAX versions donate the arena and return the new
one; these update it in place and return it.  On a CPU tensor each runs
its plain version in :mod:`.ref`; on a CUDA tensor it launches the
kernel or raises.  Launches count under ``page_bitwise_batched`` (AND,
OR), ``page_not_batched`` (NOT) and ``page_zero_scan`` (one a scan,
pair or single).  A scan's page list of up to
:data:`~repro_torch.kernels.rowclone.ops.INLINE_ROWS` pages travels in
the launch's parameters; a longer one is uploaded.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.rowclone.ops import (INLINE_ROWS, Index,
                                              _check_arena, _check_rows,
                                              _host_index, _row_bytes,
                                              _stream, upload, upload_index)
from . import ref

_OP_CODE = {"and": 0, "or": 1, "not": 2}
_COPY = 3
_MAX_GRID = 65535          # the kernels' grid y (ops, pages), z (layers)


def _stage(src: np.ndarray, dst: np.ndarray) -> bool:
    """Does some op read a page that another op of the batch writes?
    (An op on its own destination reads and writes each word in one
    thread; only a source written by another op needs staging.)"""
    writer = {int(d): i for i, d in enumerate(dst)}
    return any(writer.get(int(s), i) != i for i, s in enumerate(src))


def pim_page_bitwise_batched(arena: torch.Tensor, src_pages: Index,
                             dst_pages: Index, *, op: str) -> torch.Tensor:
    """``arena[:, dst[i]] <- arena[:, src[i]] OP arena[:, dst[i]]`` for op
    in {"and", "or"}, or ``<- ~arena[:, src[i]]`` for "not", across every
    layer, in place.  Every op reads the pre-batch arena: the page lists
    are host data, so the wrapper sees when a destination is another
    op's source and only then stages the sources through scratch (one
    gather launch, then the op's launch).  Destinations are distinct
    (the op queue flushes before a second op on one page)."""
    if op not in _OP_CODE:
        raise ValueError(f"unknown ambit bitwise op {op!r}")
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
        if op == "not":
            return ref.page_not_batched(arena, src_d, dst_d)
        return ref.page_bitwise_batched(arena, src_d, dst_d, op)
    _check_arena(arena)
    n = int(src.size)
    if n > _MAX_GRID or L > _MAX_GRID:
        raise ValueError(f"{n} ops over {L} layers: at most {_MAX_GRID} each")
    lib = _build.load("ambit")
    row = _row_bytes(arena, 2)
    stream = _stream(arena)
    name = "page_not_batched" if op == "not" else "page_bitwise_batched"
    if not _stage(src, dst):
        _build.check(lib.am_bitwise_rows(
            arena.data_ptr(), src_d.data_ptr(), P, arena.data_ptr(),
            dst_d.data_ptr(), P, n, L, row, _OP_CODE[op], stream), name)
        count_launch(name)
        return arena
    scratch = torch.empty((L, n) + tuple(arena.shape[2:]), dtype=arena.dtype,
                          device=arena.device)
    _build.check(lib.am_bitwise_rows(
        arena.data_ptr(), src_d.data_ptr(), P, scratch.data_ptr(), None, n,
        n, L, row, _COPY, stream), f"{name} (gather)")
    _build.check(lib.am_bitwise_rows(
        scratch.data_ptr(), None, n, arena.data_ptr(), dst_d.data_ptr(), P,
        n, L, row, _OP_CODE[op], stream), name)
    count_launch(name, 2)
    return arena


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
