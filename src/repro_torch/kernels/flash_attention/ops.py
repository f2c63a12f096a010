"""Wrapper for the flash-attention kernel (``csrc/flash_attention.cu``).

The port's counterpart of ``attention_inline`` in the JAX package's
``kernels/flash_attention/ops.py``.  On a CPU tensor it runs the plain
version in :mod:`.ref`; on a CUDA tensor it launches the kernel or
raises, in every mode: plain, ``lengths``, and the prefix-KV mode of
chunked prefill.  The prefix-KV mode counts its launches under
``flash_attention_prefix``.

Two routes, by dtype: bf16 (the serving path) runs its products on the
tensor cores (``mma.sync``; P is rounded to bf16 for P.V, as FA2 does),
fp32 runs the CUDA-core kernel in fp32 throughout.
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
    ``lengths`` (B,) masks keys at or beyond ``lengths[b]``.  With
    ``k_prefix``/``v_prefix`` (B, KVH, Sp, D) and ``prefix_lengths`` (B,)
    the queries also attend the prefix in full, masked only by
    ``prefix_lengths[b]`` (needs ``lengths``); the kernel reads the
    prefix through its strides, so a transposed view of a gather is
    taken as it is.  Returns (B, H, Sq, D) in q's dtype."""
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, sm_scale=sm_scale,
                             lengths=lengths, k_prefix=k_prefix,
                             v_prefix=v_prefix, prefix_lengths=prefix_lengths)
    B, H, Sq, D = q.shape
    Bk, KVH, Sk, Dk = k.shape
    if Bk != B or Dk != D or v.shape != k.shape:
        raise ValueError("q, k and v disagree on shape")
    if H % KVH or D not in (32, 64, 128):
        raise ValueError(f"unsupported heads/dim: H={H} KVH={KVH} D={D}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share a bf16 or fp32 dtype")
    q, k, v = (_words(t.contiguous()) for t in (q, k, v))
    lens = None
    if lengths is not None:
        lens = lengths.to(torch.int32).contiguous()
        if lens.shape != (B,) or lens.device != q.device:
            raise ValueError("lengths must be (B,) on q's device")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    pre = _prefix_operands(q, KVH, k_prefix, v_prefix, prefix_lengths,
                           lens)
    if sm_scale is None:
        sm_scale = D ** -0.5
    out = torch.empty_like(q)
    lib = _build.load("flash_attention")
    _build.check(lib.fa_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lens.data_ptr() if lens is not None else None, *pre["ptrs"],
        out.data_ptr(), B, H, KVH, Sq, Sk, pre["Sp"], D, int(causal),
        float(sm_scale), _DTYPES[q.dtype], *pre["strides"],
        torch.cuda.current_stream(q.device).cuda_stream), "flash_attention")
    count_launch("flash_attention_prefix" if k_prefix is not None
                 else "flash_attention")
    return out


def _words(t: torch.Tensor) -> torch.Tensor:
    """``t`` (contiguous), copied if it does not start on a 16-byte
    boundary: the bf16 route reads its rows as 16-byte words."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _prefix_operands(q, kvh, k_prefix, v_prefix, prefix_lengths,
                     lens) -> dict:
    """Pointers, length and element strides of the prefix-KV operands
    (null pointers without a prefix), checked against q."""
    if k_prefix is None:
        if v_prefix is not None or prefix_lengths is not None:
            raise ValueError("pass k_prefix, v_prefix and prefix_lengths "
                             "together")
        return {"ptrs": (None, None, None), "Sp": 0, "strides": (0, 0, 0)}
    if v_prefix is None or prefix_lengths is None or lens is None:
        raise ValueError("the prefix-KV mode needs v_prefix, "
                         "prefix_lengths and lengths")
    B, _, _, D = q.shape
    if k_prefix.shape != v_prefix.shape or k_prefix.shape[0] != B \
            or k_prefix.shape[1] != kvh or k_prefix.shape[3] != D:
        raise ValueError(f"prefix {tuple(k_prefix.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if k_prefix.stride() != v_prefix.stride() or k_prefix.stride(3) != 1:
        raise ValueError("k_prefix and v_prefix need one set of strides "
                         "and a contiguous head dim")
    if k_prefix.dtype != q.dtype or v_prefix.dtype != q.dtype:
        raise TypeError("the prefix must share q's dtype")
    if any(st % 8 for st in k_prefix.stride()[:3]) \
            or k_prefix.data_ptr() % 16 or v_prefix.data_ptr() % 16:
        # the bf16 route reads key rows as 16-byte words
        k_prefix, v_prefix = k_prefix.contiguous(), v_prefix.contiguous()
        k_prefix, v_prefix = _words(k_prefix), _words(v_prefix)
    if k_prefix.device != q.device or v_prefix.device != q.device:
        raise ValueError("the prefix must be on q's device")
    plens = prefix_lengths.to(torch.int32).contiguous()
    if plens.shape != (B,) or plens.device != q.device:
        raise ValueError("prefix_lengths must be (B,) on q's device")
    # keep the int32 copy (and any aligned copy) alive until the launch
    # is enqueued
    return {"ptrs": (k_prefix.data_ptr(), v_prefix.data_ptr(),
                     plens.data_ptr()),
            "Sp": k_prefix.shape[2],
            "strides": tuple(k_prefix.stride()[:3]),
            "keep": (k_prefix, v_prefix, plens)}
