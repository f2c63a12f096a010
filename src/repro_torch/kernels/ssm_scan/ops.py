"""Wrappers for the SSM state-arena op family (``csrc/ssm_scan.cu``).

The port's counterpart of the JAX package's ``kernels/ssm_scan/ops.py``.
State arenas are ``(groups, sublayers, slots, ...)``: conv windows and
SSD states keep their natural trailing dims, and the wrappers work on
the ``(L, R, E)`` view (``L = groups * sublayers``).  The JAX versions
donate the arena and return the new one; these update it in place and
return it.  On a CPU tensor each runs its plain version; on a CUDA
tensor it launches its kernel or raises.  An empty batch launches
nothing.

``state_scatter_pair_inline`` is the state write of the fused steps and
of the ``ssm_state_write`` flush: the whole depth of the model, conv
window and SSD state together, in one launch of the ``state_scatter``
kernel (``state_scatter_inline`` is its one-arena case).  The wrapper
is lean: it converts nothing that is already the arena's dtype,
contiguous and int32, and looks the library up once.  Row copy
(copy-on-fork) and row init (init-on-free) ride the RowClone batched
page kernels, as in the JAX package: a state row is a page of the
``(L, R, E)`` view (the fork's copy of both arenas is one launch,
``pim_state_copy_pair``).
"""

from __future__ import annotations

from array import array
from typing import List, Sequence, Tuple, Union

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.rowclone import ops as rc_ops
# rows known on the host up to INLINE_ROWS travel in the launch's
# parameters (``kInlineRows`` in ``csrc/ssm_scan.cu``); longer lists
# are uploaded
from repro_torch.kernels.rowclone.ops import (INLINE_ROWS, Index, _stream,
                                              upload_index)
from . import ref

_MAX_LAYERS = 65535        # the kernel's grid y

Rows = Union[torch.Tensor, Sequence[int]]

#: the ``ssm_scan`` library, looked up once
_lib = None


def _flat3(a: torch.Tensor) -> torch.Tensor:
    """(groups, sublayers, slots, ...) -> (groups*sublayers, slots, E),
    a view of the same storage."""
    G, M, R = a.shape[:3]
    return a.view(G * M, R, -1)


def _geometry(arena: torch.Tensor, new: torch.Tensor,
              B: int) -> Tuple[int, int, int]:
    """(layers, rows a layer, elements a row) of an arena's ``(L, R,
    E)`` view, its batch of ``B`` new rows checked against it: the same
    groups, sublayers and trailing dims, and ``B`` rows."""
    a, n = arena.shape, new.shape
    L, R = a[0] * a[1], a[2]
    E = arena.numel() // (L * R) if L * R else 0
    if tuple(n[:3]) != (a[0], a[1], B) or n[3:] != a[3:]:
        raise ValueError(f"new {tuple(n)} does not match arena "
                         f"{tuple(a)} and {B} rows")
    if L > _MAX_LAYERS:
        raise ValueError(f"{L} layers: at most {_MAX_LAYERS}")
    return L, R, E


def _scatter(arenas, news, rows: Rows) -> None:
    """``arena[:, :, rows[b]] <- new[:, :, b]`` on every arena of
    ``arenas`` (one, or the conv/SSD pair, which share their groups,
    sublayers and slots): :func:`_launch` on the card, the plain
    version on the CPU.  ``rows``: an int tensor on the arenas' device
    (a captured step's buffer), or host ints, checked here against the
    slots."""
    on_host = not isinstance(rows, torch.Tensor)
    B = len(rows) if on_host else rows.numel()
    if B == 0:
        return
    geo = [_geometry(a, n, B) for a, n in zip(arenas, news)]
    R = geo[0][1]
    if on_host:
        rows = list(map(int, rows))
        if min(rows) < 0 or max(rows) >= R:
            raise IndexError(f"state row out of range [0, {R})")
    a0 = arenas[0]
    if a0.is_cuda:
        _launch(arenas, news, rows, geo, B)
        return
    if a0.device.type != "cpu":
        raise ValueError(f"no state_scatter kernel for device {a0.device}")
    idx = torch.as_tensor(rows)
    for arena, new, (L, _, _) in zip(arenas, news, geo):
        ref.state_scatter(_flat3(arena), idx, new.reshape(L, B, -1))


def _launch(arenas, news, rows: Rows, geo=None, B=None) -> None:
    """One ``ss_state_scatter`` launch over ``arenas`` (``geo``: their
    :func:`_geometry`, and ``B`` the rows, computed here when not
    given).  Host rows travel in the launch's parameters (uploaded past
    :data:`INLINE_ROWS`); a row tensor is passed as it lies when it is
    contiguous int32, as is a ``new`` of the arena's dtype."""
    global _lib
    if B is None:
        B = rows.numel() if isinstance(rows, torch.Tensor) else len(rows)
    if geo is None:
        geo = [_geometry(a, n, B) for a, n in zip(arenas, news)]
    a0 = arenas[0]
    dev = a0.get_device()
    desc: List[int] = []
    keep = []                  # converted buffers, alive until the launch
    for arena, new, (L, R, E) in zip(arenas, news, geo):
        if not arena.is_contiguous():
            raise ValueError("arena must be contiguous")
        if new.dtype is not arena.dtype or not new.is_contiguous():
            new = new.to(arena.dtype).contiguous()
            keep.append(new)
        if new.get_device() != dev or arena.get_device() != dev:
            raise ValueError("the arenas and the new rows must share a "
                             "device")
        desc += (arena.data_ptr(), new.data_ptr(), R,
                 E * arena.element_size(), L)
    R = geo[0][1]
    dev_rows, host_rows = None, None
    if not isinstance(rows, torch.Tensor):
        if B <= INLINE_ROWS:
            host_rows = array("i", rows).tobytes()
        else:
            # freed after the launch; the allocator reuses it only for
            # work queued behind the launch on the same stream
            rows = upload_index(rows, R, "state row", a0.device)
    if host_rows is None:
        if rows.get_device() != dev:
            raise ValueError("rows must lie on the arenas' device")
        if rows.dtype is not torch.int32 or not rows.is_contiguous():
            rows = rows.to(torch.int32).contiguous()
        dev_rows = rows.data_ptr()
    if _lib is None:
        _lib = _build.load("ssm_scan")
    err = _lib.ss_state_scatter(array("q", desc).tobytes(), len(arenas),
                                dev_rows, host_rows, B, _stream(a0))
    if err:
        _build.check(err, "state_scatter")
    LAUNCHES["state_scatter"] += 1


def state_scatter_inline(arena: torch.Tensor, rows: Rows,
                         new: torch.Tensor) -> torch.Tensor:
    """``arena[:, :, rows[b]] <- new[:, :, b]`` in one launch, in place.

    arena: (groups, sublayers, slots, ...); new: (groups, sublayers,
    batch, ...); rows: (batch,) ints, a tensor on the arena's device or
    host ints.  Duplicate rows must carry identical payloads (their
    writes land in any order).  The one-arena case of
    :func:`state_scatter_pair_inline`."""
    _scatter((arena,), (new,), rows)
    return arena


def state_scatter_pair_inline(conv: torch.Tensor, ssm: torch.Tensor,
                              rows: Rows, new_conv: torch.Tensor,
                              new_ssm: torch.Tensor) -> None:
    """:func:`state_scatter_inline` on the conv window and SSD state
    arenas with one row list, in one launch (their rows differ in size
    and dtype): a step's whole state write."""
    if conv.shape[:3] != ssm.shape[:3]:
        raise ValueError(f"conv {tuple(conv.shape)} and ssm "
                         f"{tuple(ssm.shape)} arenas differ in groups, "
                         "sublayers or slots")
    _scatter((conv, ssm), (new_conv, new_ssm), rows)


def state_gather_inline(arena: torch.Tensor,
                        rows: torch.Tensor) -> torch.Tensor:
    """``arena[:, :, rows[b]]`` -> (groups, sublayers, batch, ...).
    Reads have no kernel of their own (the JAX package has none)."""
    return arena[:, :, rows.long()]


def pim_state_copy(arena: torch.Tensor, src_rows: Index,
                   dst_rows: Index) -> torch.Tensor:
    """Copy-on-fork: ``arena[:, :, dst[i]] <- arena[:, :, src[i]]``
    across every sublayer, in one RowClone batched copy."""
    rc_ops.pim_page_copy_batched(_flat3(arena), src_rows, dst_rows)
    return arena


def pim_state_copy_pair(conv: torch.Tensor, ssm: torch.Tensor,
                        src_rows: Index, dst_rows: Index) -> None:
    """:func:`pim_state_copy` on the conv and SSD state arenas with one
    row list, in one RowClone launch (their rows differ in size and
    dtype)."""
    rc_ops.pim_page_copy_batched_pair(_flat3(conv), _flat3(ssm), src_rows,
                                      dst_rows)


def pim_state_init(arena: torch.Tensor, dst_rows: Index,
                   value) -> torch.Tensor:
    """Init-on-free: ``arena[:, :, dst[i]] <- value`` in one RowClone
    batched init."""
    rc_ops.pim_page_init_batched(_flat3(arena), dst_rows, value)
    return arena
