"""Wrappers for the SSM state-arena op family (``csrc/ssm_scan.cu``).

The port's counterpart of the JAX package's ``kernels/ssm_scan/ops.py``.
State arenas are ``(groups, sublayers, slots, ...)``: conv windows and
SSD states keep their natural trailing dims, and the wrappers work on
the ``(L, R, E)`` view (``L = groups * sublayers``).  The JAX versions
donate the arena and return the new one; these update it in place and
return it.  On a CPU tensor each runs its plain version; on a CUDA
tensor it launches its kernel or raises.  An empty batch launches
nothing.

``ssd_step_rows`` is the paged decode's SSD state update: one Mamba
sublayer's recurrence of one token on arena rows, its new state written
straight into the round's new-state buffer, in one launch of
``ssd_step`` (no JAX counterpart: XLA fuses the JAX package's step).

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
from typing import List, Optional, Sequence, Tuple, Union

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
# state sizes n the ssd_step kernel is built for (its template's N), and
# the most batch rows of a launch (its grid y)
SSD_STATE_DIMS = (16, 32, 64, 128, 256)
_MAX_STEP_ROWS = 65535

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


def _rows_dense(t: torch.Tensor) -> bool:
    """Whether ``t``'s dims after the first are dense (row-major, any
    stride on a dim of size 1)."""
    expect = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size != 1 and stride != expect:
            return False
        expect *= size
    return True


def _step_operands(arena, rows, rowmap, alive, x, dt, A, B, C, out):
    """Check :func:`ssd_step_rows`' operands against what its kernel
    takes (shapes, dtypes, dense inner dims, one device); raises
    ``ValueError``."""
    if arena.dim() != 4 or rows.dim() != 1:
        raise ValueError(f"arena {tuple(arena.shape)}, rows "
                         f"{tuple(rows.shape)}: (R, h, p, n) and (Bp,)")
    _, H, P, N = arena.shape
    Bp = rows.shape[0]
    want = {"rows": (rows, (Bp,), (torch.int32,)),
            "rowmap": (rowmap, (Bp,), (torch.int64,)),
            "x": (x, (Bp, H, P), (torch.bfloat16, torch.float32)),
            "dt": (dt, (Bp, H), (torch.float32,)),
            "A": (A, (H,), (torch.float32,)),
            "B": (B, (Bp, N), (x.dtype,)),
            "C": (C, (Bp, N), (x.dtype,)),
            "out": (out, (Bp, H, P, N), (torch.float32,))}
    if alive is not None:
        want["alive"] = (alive, (Bp,), (torch.bool,))
    if arena.dtype is not torch.float32:
        raise ValueError(f"arena is {arena.dtype}: float32 state rows")
    for name, (t, shape, dtypes) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)}: want {shape}")
        if t.dtype not in dtypes:
            raise ValueError(f"{name} is {t.dtype}: want one of {dtypes}")
        if t.device != arena.device:
            raise ValueError(f"{name} is on {t.device}, the arena on "
                             f"{arena.device}")
    # x, B, C may be views of the conv's output: rows apart by a stride,
    # their inner dims dense
    for name, t in (("x", x), ("B", B), ("C", C)):
        if not _rows_dense(t):
            raise ValueError(f"{name} strides {t.stride()}: its inner "
                             "dims must be dense")
    for name, t in (("arena", arena), ("rows", rows), ("rowmap", rowmap),
                    ("dt", dt), ("A", A), ("out", out), ("alive", alive)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ssd_step_rows(arena: torch.Tensor, rows: torch.Tensor,
                  rowmap: torch.Tensor, alive: Optional[torch.Tensor],
                  x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor,
                  out: torch.Tensor) -> torch.Tensor:
    """One decode token's SSD recurrence on a Mamba sublayer's arena
    rows, in one launch: row ``q``'s new state is ``arena[rows[q]] *
    exp(dt[q] * A) + B[q] * (dt[q] * x[q])``; ``out[b]`` gets row
    ``rowmap[b]``'s (its old state where ``alive`` is False).  Returns y:
    (Bp, h, p) float32, ``C[b]`` against row ``b``'s new state.

    arena: (R, h, p, n) float32, one sublayer's view of the SSD arena;
    rows: (Bp,) int32 arena rows; rowmap: (Bp,) int64 (pad rows fold onto
    row 0); alive: (Bp,) bool or None; x: (Bp, h, p) and B, C: (Bp, n)
    in bf16 or float32, rows a stride apart and inner dims dense (views
    of the conv's output are taken as they lie); dt: (Bp, h) and A: (h,)
    float32; out: (Bp, h, p, n) float32.  On the CPU it runs the plain
    version (the gather, the step, the mask and the fold as separate
    ops); on the card the kernel, whose new state equals those ops bit
    for bit and whose y sums over n in its own order.  Nothing is
    allocated but y, so a captured step replays it."""
    _step_operands(arena, rows, rowmap, alive, x, dt, A, B, C, out)
    if arena.is_cuda:
        return _launch_step(arena, rows, rowmap, alive, x, dt, A, B, C, out)
    if arena.device.type != "cpu":
        raise ValueError(f"no ssd_step kernel for device {arena.device}")
    return ref.ssd_step_rows(arena, rows, rowmap, alive, x, dt, A, B, C, out)


def _launch_step(arena, rows, rowmap, alive, x, dt, A, B, C,
                 out) -> torch.Tensor:
    """One ``ss_ssd_step`` launch on operands :func:`_step_operands`
    passed: each pointer as it lies, x's, B's and C's row strides beside
    theirs.  Returns y."""
    global _lib
    _, H, P, N = arena.shape
    Bp = rows.shape[0]
    if N not in SSD_STATE_DIMS:
        raise ValueError(f"state size {N}: the ssd_step kernel is built for "
                         f"{SSD_STATE_DIMS}")
    if Bp > _MAX_STEP_ROWS:
        raise ValueError(f"{Bp} rows: at most {_MAX_STEP_ROWS}")
    if arena.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("arena and out must be 16-byte aligned")
    y = torch.empty((Bp, H, P), dtype=torch.float32, device=arena.device)
    if _lib is None:
        _lib = _build.load("ssm_scan")
    err = _lib.ss_ssd_step(
        arena.data_ptr(), rows.data_ptr(), rowmap.data_ptr(),
        None if alive is None else alive.data_ptr(), x.data_ptr(),
        x.stride(0), dt.data_ptr(), A.data_ptr(), B.data_ptr(), B.stride(0),
        C.data_ptr(), C.stride(0), out.data_ptr(), y.data_ptr(), Bp, H, P, N,
        int(x.dtype is torch.bfloat16), _stream(arena))
    if err:
        _build.check(err, "ssd_step")
    LAUNCHES["ssd_step"] += 1
    return y
