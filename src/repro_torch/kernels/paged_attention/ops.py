"""Wrapper for paged decode attention (``csrc/paged_attention.cu``).

The port's counterpart of ``paged_attention_inline`` in the JAX
package's ``kernels/paged_attention/ops.py``.  On a CPU tensor it runs
the plain version in :mod:`.ref`; on a CUDA tensor it launches the
kernel or raises.  Nothing here reads ``lengths`` or ``block_tables`` on
the host: the kernel takes them as device operands, and its grid of
(B, KVH, partitions) comes from the block table's width, so no launch
specialises on their values.  One launch a call: the kernel splits each
sequence into partitions of :data:`PARTITION_TOKENS` and its last block
per (sequence, kv head) merges them.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.kernels import _build, count_launch
from . import ref

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

#: tokens of a sequence one block of the kernel attends (a multiple of 64)
PARTITION_TOKENS = 128

# per device: the kernel's merge tickets, zero between launches (each
# launch's merging blocks reset theirs), grown on demand.  A grown-out
# buffer is kept alive: a captured CUDA graph holds its address.
_TICKETS: Dict[torch.device, List[torch.Tensor]] = {}


def num_partitions(max_pages: int, page_size: int) -> int:
    """The grid's partition count: from the block table's width (a host
    shape), never from ``lengths``."""
    return max(1, -(-max_pages * page_size // PARTITION_TOKENS))


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    held = _TICKETS.setdefault(device, [])
    if not held or held[-1].numel() < n:
        held.append(torch.zeros(max(n, 256), dtype=torch.int32,
                                device=device))
    return held[-1]


def paged_attention(q: torch.Tensor, k_arena: torch.Tensor,
                    v_arena: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, *,
                    sm_scale: Optional[float] = None,
                    k_self: Optional[torch.Tensor] = None,
                    v_self: Optional[torch.Tensor] = None,
                    return_lse: bool = False):
    """Decode attention over a paged KV arena.

    q: (B, H, D); k_arena/v_arena: (pages, page_size, KVH, D);
    block_tables: (B, max_pages) int; lengths: (B,) int; k_self/v_self:
    optional (B, KVH, D) current-token K/V merged at ``lengths[b]``.
    Returns o (B, H, D), or (o, m, l) with fp32 (B, H) statistics when
    ``return_lse``.
    """
    if (k_self is None) != (v_self is None):
        raise ValueError("pass k_self and v_self together")
    if q.device.type == "cpu":
        return ref.paged_attention(q, k_arena, v_arena, block_tables,
                                   lengths, sm_scale=sm_scale, k_self=k_self,
                                   v_self=v_self, return_lse=return_lse)
    B, H, D = q.shape
    _, S, KVH, Dk = k_arena.shape
    if Dk != D or v_arena.shape != k_arena.shape:
        raise ValueError("q, k_arena and v_arena disagree on shape")
    if H % KVH or H // KVH > 32 or D not in (32, 64, 128, 256):
        raise ValueError(f"unsupported heads/dim: H={H} KVH={KVH} D={D}")
    dtype = q.dtype
    if dtype not in _DTYPES or k_arena.dtype != dtype \
            or v_arena.dtype != dtype:
        raise TypeError("q and the arenas must share a bf16 or fp32 dtype")
    operands = [q, k_arena, v_arena, block_tables, lengths]
    if k_self is not None:
        k_self = k_self.to(dtype).contiguous()
        v_self = v_self.to(dtype).contiguous()
        if k_self.shape != (B, KVH, D) or v_self.shape != (B, KVH, D):
            raise ValueError("k_self/v_self must be (B, KVH, D)")
        operands += [k_self, v_self]
    if any(t.device != q.device for t in operands):
        raise ValueError("all operands must be on one device")
    if not (q.is_contiguous() and k_arena.is_contiguous()
            and v_arena.is_contiguous()):
        raise ValueError("q and the arenas must be contiguous")
    if k_arena.data_ptr() % 16 or v_arena.data_ptr() % 16:
        raise ValueError("the arenas must be 16-byte aligned (the kernel "
                         "reads them by 16-byte words)")
    bt = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    if bt.shape[0] != B or lens.shape != (B,):
        raise ValueError("block_tables/lengths must have B rows")
    if sm_scale is None:
        sm_scale = D ** -0.5
    out = torch.empty_like(q)
    m = l = None
    if return_lse:
        m = torch.empty((B, H), dtype=torch.float32, device=q.device)
        l = torch.empty((B, H), dtype=torch.float32, device=q.device)
    npart = num_partitions(bt.shape[1], S)
    # the partitions' (m, l, acc), merged in the same launch
    scratch = torch.empty((B, KVH, npart, H // KVH, D + 2),
                          dtype=torch.float32, device=q.device)
    tickets = _tickets(q.device, B * KVH)
    lib = _build.load("paged_attention")
    _build.check(lib.pa_paged_attention(
        q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(), bt.data_ptr(),
        lens.data_ptr(), k_self.data_ptr() if k_self is not None else None,
        v_self.data_ptr() if v_self is not None else None, out.data_ptr(),
        m.data_ptr() if m is not None else None,
        l.data_ptr() if l is not None else None, scratch.data_ptr(),
        tickets.data_ptr(), B, H, KVH, D, S, bt.shape[1], npart,
        PARTITION_TOKENS, float(sm_scale), _DTYPES[dtype],
        torch.cuda.current_stream(q.device).cuda_stream), "paged_attention")
    count_launch("paged_attention")
    if return_lse:
        return out, m, l
    return out
