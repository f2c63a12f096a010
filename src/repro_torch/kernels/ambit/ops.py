"""Wrappers for the Ambit kernels (``csrc/ambit.cu``).

The port's counterpart of the JAX package's ``kernels/ambit/ops.py``:
``pim_page_bitwise_batched`` (AND, OR and NOT) and
``pim_page_zero_scan``.  The ops are defined on bit patterns, so any
dtype works and a float arena is never converted.  The JAX versions
donate the arena and return the new one; these update it in place and
return it.  On a CPU tensor each runs its plain version in :mod:`.ref`;
on a CUDA tensor it launches the kernel or raises.  Launches count
under ``page_bitwise_batched`` (AND, OR), ``page_not_batched`` (NOT)
and ``page_zero_scan``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.rowclone.ops import (Index, _check_arena,
                                              _host_index, _row_bytes,
                                              _stream, upload_index)
from . import ref

_OP_CODE = {"and": 0, "or": 1, "not": 2}
_COPY = 3
_MAX_GRID = 65535          # the kernels' grid y (ops) and z (layers)


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
    (a bf16 ``-0.0`` is a nonzero bit).  Read-only; one launch."""
    idx = _host_index(pages)
    if idx.size == 0:
        return torch.zeros((0,), dtype=torch.bool, device=arena.device)
    L, P = arena.shape[:2]
    pages_d = upload_index(idx, P, "page", arena.device)
    if arena.device.type == "cpu":
        return ref.page_zero_scan(arena, pages_d)
    _check_arena(arena)
    n = int(idx.size)
    if n > _MAX_GRID or L > _MAX_GRID:
        raise ValueError(f"{n} pages over {L} layers: at most {_MAX_GRID} "
                         "each")
    lib = _build.load("ambit")
    flags = torch.zeros((n,), dtype=torch.int32, device=arena.device)
    _build.check(lib.am_zero_scan(
        arena.data_ptr(), pages_d.data_ptr(), P, n, L, _row_bytes(arena, 2),
        flags.data_ptr(), _stream(arena)), "page_zero_scan")
    count_launch("page_zero_scan")
    return flags == 0
