"""Plain PyTorch version of flash attention (the JAX package's
``kernels/flash_attention/ref.py``): naive masked softmax attention in
fp32, with the same causal, ``lengths`` and prefix-KV masks.

One difference from the JAX reference, kept on purpose: a row with no
unmasked key gives 0 here (as the CUDA kernel does) where the JAX
reference gives the mean of ``v``.  The serving path never forms such a
row (``lengths >= 1`` under the causal mask).

``round_p=True`` rounds the softmax weights P to bf16 before P.V, as the
kernel's tensor-core route does (the row sum stays fp32); the tests use
it to show that rounding fits the card's tolerance."""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, sm_scale: Optional[float] = None,
              lengths: Optional[torch.Tensor] = None,
              k_prefix: Optional[torch.Tensor] = None,
              v_prefix: Optional[torch.Tensor] = None,
              prefix_lengths: Optional[torch.Tensor] = None,
              round_p: bool = False) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, KVH, Sk, D).  With ``k_prefix`` /
    ``v_prefix`` (B, KVH, Sp, D) the queries also attend the prefix in
    full, masked per row by ``prefix_lengths`` only."""
    sp = 0
    if k_prefix is not None:
        if v_prefix is None or prefix_lengths is None or lengths is None:
            raise ValueError("the prefix-KV path needs v_prefix, "
                             "prefix_lengths and lengths")
        sp = k_prefix.shape[2]
        k = torch.cat([k_prefix, k], dim=2)
        v = torch.cat([v_prefix, v], dim=2)
    b, h, sq, d = q.shape
    _, kvh, sk, _ = k.shape
    group = h // kvh
    if sm_scale is None:
        sm_scale = d ** -0.5
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    dev = q.device
    col = torch.arange(sk, device=dev)
    row = torch.arange(sq, device=dev)[:, None]
    if sp:
        cc = col[None, :] - sp
        chunk_ok = cc < lengths.long()[:, None]                # (B, sk)
        if causal:
            chunk_ok = chunk_ok[:, None, :] & (cc[None] <= row)
        else:
            chunk_ok = chunk_ok[:, None, :].expand(b, sq, sk)
        pref_ok = (col[None, :] < prefix_lengths.long()[:, None])[:, None, :]
        mask = torch.where(col[None, None, :] < sp, pref_ok, chunk_ok)
    else:
        mask = torch.ones((b, sq, sk), dtype=torch.bool, device=dev)
        if lengths is not None:
            mask = mask & (col[None, None, :] < lengths.long()[:, None, None])
        if causal:
            mask = mask & (col[None, :] <= row)[None]
    mask = mask[:, None]                                        # (B,1,sq,sk)
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    if round_p:
        p = p.to(torch.bfloat16).float()
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    out = out / torch.where(l == 0.0, torch.ones_like(l), l)
    return out.to(q.dtype)
