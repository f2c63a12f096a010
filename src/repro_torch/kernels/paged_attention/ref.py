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


def paged_attention_split(q: torch.Tensor, k_arena: torch.Tensor,
                          v_arena: torch.Tensor, block_tables: torch.Tensor,
                          lengths: torch.Tensor, *, part: int,
                          sm_scale: Optional[float] = None,
                          k_self: Optional[torch.Tensor] = None,
                          v_self: Optional[torch.Tensor] = None):
    """The CUDA kernel's arithmetic in plain PyTorch (for the tests):
    each sequence's history cut into partitions of ``part`` tokens, each
    partition's (m, l, acc) taken alone, then merged in fp32 with the
    current token: m = max(m_i, s_self), l = sum_i l_i exp(m_i - m) +
    exp(s_self - m), o = (sum_i acc_i exp(m_i - m) + exp(s_self - m)
    v_self) / l.  A partition past a row's length holds (-1e30, 0, 0).
    Returns (o, m, l) as :func:`paged_attention` with ``return_lse``."""
    bsz, h, d = q.shape
    _, page_size, kvh, _ = k_arena.shape
    groups = h // kvh
    if sm_scale is None:
        sm_scale = d ** -0.5
    max_len = block_tables.shape[1] * page_size
    npart = max(1, -(-max_len // part))
    bt = block_tables.long()
    k = k_arena[bt].reshape(bsz, max_len, kvh, d).float()
    v = v_arena[bt].reshape(bsz, max_len, kvh, d).float()
    pad = npart * part - max_len
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    valid = (torch.arange(npart * part, device=q.device)[None, :]
             < lengths.long()[:, None])                  # (B, T)
    qg = q.reshape(bsz, kvh, groups, d).float() * sm_scale
    s = torch.einsum("bkgd,btkd->bkgt", qg, k)
    s = s.reshape(bsz, kvh, groups, npart, part)
    vmask = valid.reshape(bsz, 1, 1, npart, part)
    s = torch.where(vmask, s, torch.full_like(s, _NEG_INF))
    m_i = s.amax(dim=-1)                                 # (B,KVH,G,NP)
    p = torch.where(vmask, torch.exp(s - m_i[..., None]),
                    torch.zeros_like(s))
    l_i = p.sum(dim=-1)
    acc_i = torch.einsum("bkgnt,bntkd->bkgnd", p,
                         v.reshape(bsz, npart, part, kvh, d))
    m = m_i.amax(dim=-1)
    if k_self is not None:
        s_self = torch.einsum("bkgd,bkd->bkg", qg, k_self.float())
        m = torch.maximum(m, s_self)
    w_i = torch.exp(m_i - m[..., None])
    l = (l_i * w_i).sum(dim=-1)
    acc = (acc_i * w_i[..., None]).sum(dim=-2)
    if k_self is not None:
        w_self = torch.exp(s_self - m)
        l = l + w_self
        acc = acc + w_self[..., None] * v_self.float()[:, :, None, :]
    out = acc / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]
    return (out.reshape(bsz, h, d).to(q.dtype), m.reshape(bsz, h),
            l.reshape(bsz, h))
