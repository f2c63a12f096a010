"""Plain PyTorch version of paged decode attention (the JAX package's
``kernels/paged_attention/ref.py``), with the same fusion hooks: an
optional current-token K/V (``k_self``/``v_self``) merged at position
``lengths[b]``, and optional ``(m, l)`` softmax statistics defined as
the kernel keeps them (a row with no key has ``m = -1e30, l = 0`` and
outputs 0).  Computes in fp32."""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def paged_attention(q: torch.Tensor, k_arena: torch.Tensor,
                    v_arena: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, *,
                    sm_scale: Optional[float] = None,
                    k_self: Optional[torch.Tensor] = None,
                    v_self: Optional[torch.Tensor] = None,
                    return_lse: bool = False):
    bsz, h, d = q.shape
    _, page_size, kvh, _ = k_arena.shape
    groups = h // kvh
    if sm_scale is None:
        sm_scale = d ** -0.5
    max_pages = block_tables.shape[1]
    max_len = max_pages * page_size

    bt = block_tables.long()
    k = k_arena[bt].reshape(bsz, max_len, kvh, d)     # (B, S, KVH, D)
    v = v_arena[bt].reshape(bsz, max_len, kvh, d)
    pos = torch.arange(max_len, device=q.device)
    valid = pos[None, :] < lengths.long()[:, None]    # (B, S)
    if k_self is not None:
        # the current token after the history, always attended
        k = torch.cat([k, k_self[:, None].to(k.dtype)], dim=1)
        v = torch.cat([v, v_self[:, None].to(v.dtype)], dim=1)
        valid = torch.cat(
            [valid, torch.ones((bsz, 1), dtype=torch.bool,
                               device=q.device)], dim=1)

    qg = q.reshape(bsz, kvh, groups, d).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * sm_scale
    mask = valid[:, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = torch.clamp(s.amax(dim=-1), min=_NEG_INF)
    p = torch.exp(s - m[..., None])
    p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    out = out / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]
    out = out.reshape(bsz, h, d).to(q.dtype)
    if return_lse:
        return out, m.reshape(bsz, h), l.reshape(bsz, h)
    return out
