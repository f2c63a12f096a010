"""Wrappers for the SSM state-arena op family (``csrc/ssm_scan.cu``).

The port's counterpart of the JAX package's ``kernels/ssm_scan/ops.py``.
State arenas are ``(groups, sublayers, slots, ...)``: conv windows and
SSD states keep their natural trailing dims, and the wrappers work on
the ``(L, R, E)`` view (``L = groups * sublayers``).  The JAX versions
donate the arena and return the new one; these update it in place and
return it.  On a CPU tensor each runs its plain version; on a CUDA
tensor it launches its kernel or raises.  An empty batch launches
nothing.

``state_scatter_inline`` is the state write of the fused steps and of
the ``ssm_state_write`` flush: the whole depth of the model in one
launch of the ``state_scatter`` kernel.  Row copy (copy-on-fork) and
row init (init-on-free) ride the RowClone batched page kernels, as in
the JAX package: a state row is a page of the ``(L, R, E)`` view (the
fork's copy of both arenas is one launch, ``pim_state_copy_pair``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.rowclone import ops as rc_ops
from repro_torch.kernels.rowclone.ops import Index, _row_bytes, _stream
from . import ref

_MAX_GRID = 65535          # the kernel's grid y (rows) and z (layers)


def _flat3(a: torch.Tensor) -> torch.Tensor:
    """(groups, sublayers, slots, ...) -> (groups*sublayers, slots, E),
    a view of the same storage."""
    G, M, R = a.shape[:3]
    return a.view(G * M, R, -1)


def state_scatter_inline(arena: torch.Tensor, rows: torch.Tensor,
                         new: torch.Tensor) -> torch.Tensor:
    """``arena[:, :, rows[b]] <- new[:, :, b]`` in one launch, in place.

    arena: (groups, sublayers, slots, ...); new: (groups, sublayers,
    batch, ...); rows: (batch,) int on the arena's device.  Duplicate
    rows must carry identical payloads (their writes land in any
    order)."""
    B = rows.shape[0]
    if B == 0:
        return arena
    G, M, R = arena.shape[:3]
    if tuple(new.shape[:3]) != (G, M, B) \
            or new.shape[3:] != arena.shape[3:]:
        raise ValueError(f"new {tuple(new.shape)} does not match arena "
                         f"{tuple(arena.shape)} and {B} rows")
    if arena.device.type == "cpu":
        ref.state_scatter(_flat3(arena), rows, new.reshape(G * M, B, -1))
        return arena
    if not arena.is_contiguous():
        raise ValueError("arena must be contiguous")
    if new.device != arena.device or rows.device != arena.device:
        raise ValueError("arena, new and rows must share a device")
    L = G * M
    if B > _MAX_GRID or L > _MAX_GRID:
        raise ValueError(f"{B} rows over {L} layers: at most {_MAX_GRID} "
                         "each")
    new = new.to(arena.dtype).contiguous()
    rows = rows.to(torch.int32).contiguous()
    lib = _build.load("ssm_scan")
    _build.check(lib.ss_state_scatter(
        arena.data_ptr(), new.data_ptr(), rows.data_ptr(), L, B, R,
        _row_bytes(arena, 3), _stream(arena)), "state_scatter")
    count_launch("state_scatter")
    return arena


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
