"""Wrapper for the flash-attention kernel (``csrc/flash_attention.cu``).

The port's counterpart of ``attention_inline`` in the JAX package's
``kernels/flash_attention/ops.py``.  On a CPU tensor it runs the plain
version in :mod:`.ref` (every mode, the prefix-KV one included); on a
CUDA tensor it launches the kernel (plain and ``lengths`` modes) or
raises.  The prefix-KV mode serves chunked prefill, a later slice, and
has no kernel yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, count_launch
from . import ref

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, sm_scale: Optional[float] = None,
              lengths: Optional[torch.Tensor] = None,
              k_prefix: Optional[torch.Tensor] = None,
              v_prefix: Optional[torch.Tensor] = None,
              prefix_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, KVH, Sk, D) with H % KVH == 0;
    ``lengths`` (B,) masks keys at or beyond ``lengths[b]``.  Returns
    (B, H, Sq, D) in q's dtype."""
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, sm_scale=sm_scale,
                             lengths=lengths, k_prefix=k_prefix,
                             v_prefix=v_prefix, prefix_lengths=prefix_lengths)
    if k_prefix is not None:
        raise NotImplementedError(
            "the prefix-KV mode of flash attention has no CUDA kernel yet "
            "(it serves chunked prefill, a later slice)")
    B, H, Sq, D = q.shape
    Bk, KVH, Sk, Dk = k.shape
    if Bk != B or Dk != D or v.shape != k.shape:
        raise ValueError("q, k and v disagree on shape")
    if H % KVH or D not in (32, 64, 128):
        raise ValueError(f"unsupported heads/dim: H={H} KVH={KVH} D={D}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share a bf16 or fp32 dtype")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lens = None
    if lengths is not None:
        lens = lengths.to(torch.int32).contiguous()
        if lens.shape != (B,) or lens.device != q.device:
            raise ValueError("lengths must be (B,) on q's device")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if sm_scale is None:
        sm_scale = D ** -0.5
    out = torch.empty_like(q)
    lib = _build.load("flash_attention")
    _build.check(lib.fa_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lens.data_ptr() if lens is not None else None, out.data_ptr(),
        B, H, KVH, Sq, Sk, D, int(causal), float(sm_scale), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream), "flash_attention")
    count_launch("flash_attention")
    return out
