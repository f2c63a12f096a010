"""Plain PyTorch versions of the SSM state-arena ops (the JAX package's
``kernels/ssm_scan/ref.py``), on the flattened ``(L, R, E)`` arena:
``L`` is groups x Mamba sublayers, ``R`` the state rows (one per live
sequence).  They update the arena in place; the wrappers in :mod:`.ops`
run them on CPU tensors, and the kernels are held against them on the
card.  :func:`ssd_step` is the Mamba-2 layer's one-token SSD recurrence
(``models/ssm.py`` runs it), and :func:`ssd_step_rows` the same step on
a sublayer's arena rows, as the paged engine's decode runs it.
"""

from __future__ import annotations

from typing import Optional

import torch


def state_scatter(arena: torch.Tensor, rows: torch.Tensor,
                  new: torch.Tensor) -> torch.Tensor:
    """``arena[:, rows[b]] <- new[:, b]``.  arena: (L, R, E); rows: (B,);
    new: (L, B, E).  Duplicate rows carry identical payloads by the
    caller's contract, so the order of the writes does not matter."""
    arena[:, rows.long()] = new.to(arena.dtype)
    return arena


def state_gather(arena: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``arena[:, rows[b]]`` -> (L, B, E), the scatter's inverse."""
    return arena[:, rows.long()]


def ssd_step(xh, dt, A, B, C, state):
    """One token's SSD recurrence (s == 1): returns (y (b, 1, h, p) in
    float32, the new state).  xh: (b, 1, h, p); dt: (b, 1, h) float32;
    A: (h,); B, C: (b, 1, n); state: (b, h, p, n) float32."""
    dA = torch.exp(dt[:, 0] * A[None, :])                      # (b,h)
    dBx = (B[:, 0].float()[:, None, None, :]
           * (dt[:, 0][:, :, None] * xh[:, 0].float())[..., None])
    new_state = state * dA[:, :, None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", C[:, 0].float(), new_state)
    return y[:, None], new_state


def ssd_step_rows(arena: torch.Tensor, rows: torch.Tensor,
                  rowmap: torch.Tensor, alive: Optional[torch.Tensor],
                  x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor,
                  out: torch.Tensor) -> torch.Tensor:
    """:func:`ssd_step` on arena rows: gather the rows' state, step it,
    keep a dead row's old state (``alive`` False), and fold the rows by
    ``rowmap`` into ``out`` (``out[b]`` holds row ``rowmap[b]``'s).

    arena: (R, h, p, n); rows, rowmap, alive: (Bp,); x: (Bp, h, p); dt:
    (Bp, h); A: (h,); B, C: (Bp, n); out: (Bp, h, p, n) of the arena's
    dtype.  Returns y: (Bp, h, p) float32, each row from its own state."""
    state = arena[rows.long()]
    y, new = ssd_step(x[:, None], dt[:, None], A, B[:, None], C[:, None],
                      state)
    new = new.to(arena.dtype)
    if alive is not None:
        new = torch.where(alive[:, None, None, None], new, state)
    torch.index_select(new, 0, rowmap, out=out)
    return y[:, 0]
