"""Attention: GQA/MQA, MLA (DeepSeek), cross-attention; the tiled
(flash-style) forward and the dense-cache decode path.

The port's counterpart of the JAX package's ``models/attention.py``, in
plain PyTorch (none of it reaches a Pallas kernel; the serving engine's
paged path runs the flash and paged-attention kernels instead):

* ``chunked_attention`` — the JAX package's tiled online-softmax with
  its custom VJP, as a ``torch.autograd.Function`` (``_Flash``): the
  static list of reachable (q tile, k tile) pairs walked by a Python
  loop with running (m, l, acc) per q position, so no (sq, sk) score
  tensor is materialised and causal tiles that cannot contribute are
  never visited.  The forward keeps only ``out`` and the log-sum-exp
  ``lse``; the backward walks the same pairs, recomputing each tile's
  probabilities from ``lse`` with ``delta = sum(out * dout)``, so
  training holds O(s * d) per layer as the reference does.
* ``decode_attention`` — one token against a dense (b, S, kvh, hd)
  cache masked at each row's length.
* MLA — prefill expands the latent to per-head k/v; decode runs in
  absorbed form against the compressed (c_kv, k_rope) cache.

Layouts are the JAX package's: q (b, s, h, hd), k/v (b, s, kvh, hd),
heads grouped kv-major (head ``j * g + i`` reads kv head ``j``).  The
JAX caches are immutable and its layers return new ones; here
``_write_kv`` and the MLA cache writes update the caller's cache
tensors in place (no second copy of a cache) and return them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, ParallelConfig
from .layers import apply_rope, cast, rmsnorm, rope_sincos
from .params import ParamDef

_NEG_INF = -1e30


# --------------------------------------------------------------------- #
# Parameter definitions
# --------------------------------------------------------------------- #


def attn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, h, kvh, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
    if cfg.mla:
        m = cfg.mla
        defs = {
            "wq": ParamDef((d, h, m.nope_head_dim + m.rope_head_dim),
                           ("embed", "heads", None)),
            "wkv_a": ParamDef((d, m.kv_lora_rank + m.rope_head_dim),
                              ("embed", None)),
            "ckv_norm": ParamDef((m.kv_lora_rank,), (None,), init="ones"),
            "wk_b": ParamDef((m.kv_lora_rank, h, m.nope_head_dim),
                             ("kv_lora", "heads", None)),
            "wv_b": ParamDef((m.kv_lora_rank, h, m.v_head_dim),
                             ("kv_lora", "heads", None)),
            "wo": ParamDef((h, m.v_head_dim, d), ("heads", None, "embed")),
        }
        if m.q_lora_rank:
            defs["wq_a"] = ParamDef((d, m.q_lora_rank), ("embed", None))
            defs["q_norm"] = ParamDef((m.q_lora_rank,), (None,), init="ones")
            defs["wq"] = ParamDef(
                (m.q_lora_rank, h, m.nope_head_dim + m.rope_head_dim),
                (None, "heads", None))
        return defs
    return {
        "wq": ParamDef((d, h, hd), ("dmodel_rp", "heads", None)),
        "wk": ParamDef((d, kvh, hd), ("dmodel_rp", "kv_heads", None)),
        "wv": ParamDef((d, kvh, hd), ("dmodel_rp", "kv_heads", None)),
        "wo": ParamDef((h, hd, d), ("heads", None, "dmodel_rp")),
    }


# --------------------------------------------------------------------- #
# Tiled (flash-style) attention: forward and custom backward
# --------------------------------------------------------------------- #


def _tile_pairs(nq: int, nk: int, causal: bool, cq: int, ck: int,
                q_offset: int) -> np.ndarray:
    pairs = []
    for i in range(nq):
        q_end = q_offset + (i + 1) * cq - 1
        for j in range(nk):
            if causal and j * ck > q_end:
                continue
            pairs.append((i, j))
    return np.asarray(pairs, np.int32)


def _tile_mask(bias, i, j, cq, ck, q_offset, causal):
    """Additive mask of tile (i, j): the length bias of its keys, and
    -1e30 above the diagonal when causal."""
    dev = bias.device
    mask = bias[:, None, None, None, j * ck:(j + 1) * ck]
    if causal:
        qpos = q_offset + i * cq + torch.arange(cq, device=dev)
        kpos = j * ck + torch.arange(ck, device=dev)
        mask = mask + torch.where(kpos[None, :] <= qpos[:, None], 0.0,
                                  _NEG_INF)
    return mask


def _pack(q, k, v, cq, ck):
    """Pad the sequence dims to tile multiples, in float32:
    q (b, kvh, g, SQ, dh), k and v (b, kvh, SK, dh)."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    pq, pk = (-sq) % cq, (-k.shape[1]) % ck
    qf = F.pad(q, (0, 0, 0, 0, 0, pq)).float().transpose(1, 2).reshape(
        b, kvh, h // kvh, sq + pq, dh)
    kf = F.pad(k, (0, 0, 0, 0, 0, pk)).float().transpose(1, 2)
    vf = F.pad(v, (0, 0, 0, 0, 0, pk)).float().transpose(1, 2)
    return qf, kf, vf


def _flash_fwd_tiles(qf, kf, vf, bias, pairs, cq, ck, q_offset, causal,
                     scale):
    """The online-softmax walk; returns out (b, kvh, g, SQ, dh) and lse
    (b, kvh, g, SQ, 1), both float32 (``_flash_fwd_scan``)."""
    b, kvh, g, SQ, dh = qf.shape
    dev = qf.device
    m = torch.full((b, kvh, g, SQ, 1), _NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, kvh, g, SQ, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, g, SQ, dh), dtype=torch.float32, device=dev)
    for i, j in pairs:
        qs, ks = slice(i * cq, (i + 1) * cq), slice(j * ck, (j + 1) * ck)
        s = torch.einsum("bkgqd,bkcd->bkgqc", qf[:, :, :, qs], kf[:, :, ks])
        s = s * scale + _tile_mask(bias, i, j, cq, ck, q_offset, causal)
        m_prev, l_prev = m[:, :, :, qs], l[:, :, :, qs]
        m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m_prev - m_new)
        l[:, :, :, qs] = alpha * l_prev + p.sum(dim=-1, keepdim=True)
        acc[:, :, :, qs] = alpha * acc[:, :, :, qs] + torch.einsum(
            "bkgqc,bkcd->bkgqd", p, vf[:, :, ks])
        m[:, :, :, qs] = m_new
    lsafe = torch.where(l == 0.0, torch.ones_like(l), l)
    return acc / lsafe, m + torch.log(lsafe)


def _flash_bwd_tiles(qf, kf, vf, bias, out, lse, dout, pairs, cq, ck,
                     q_offset, causal, scale):
    """``_flash_bwd_scan``: each tile's probabilities recomputed from
    ``lse``; returns dq, dk, dv in the packed float32 layouts."""
    delta = (out * dout).sum(dim=-1, keepdim=True)        # (b,kvh,g,SQ,1)
    dq, dk, dv = (torch.zeros_like(qf), torch.zeros_like(kf),
                  torch.zeros_like(vf))
    for i, j in pairs:
        qs, ks = slice(i * cq, (i + 1) * cq), slice(j * ck, (j + 1) * ck)
        qd, kd, vd, dod = qf[:, :, :, qs], kf[:, :, ks], vf[:, :, ks], \
            dout[:, :, :, qs]
        s = torch.einsum("bkgqd,bkcd->bkgqc", qd, kd)
        s = s * scale + _tile_mask(bias, i, j, cq, ck, q_offset, causal)
        p = torch.exp(s - lse[:, :, :, qs])
        dv[:, :, ks] += torch.einsum("bkgqc,bkgqd->bkcd", p, dod)
        dp = torch.einsum("bkgqd,bkcd->bkgqc", dod, vd)
        ds = p * (dp - delta[:, :, :, qs])
        dq[:, :, :, qs] += torch.einsum("bkgqc,bkcd->bkgqd", ds, kd) * scale
        dk[:, :, ks] += torch.einsum("bkgqc,bkgqd->bkcd", ds, qd) * scale
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """The JAX package's ``_flash`` custom VJP.  The forward's in-place
    tile updates run here, outside autograd's view; the bias (the
    length mask) takes no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, cq, ck, q_offset, causal, scale):
        b, sq, h, dh = q.shape
        qf, kf, vf = _pack(q, k, v, cq, ck)
        pairs = _tile_pairs(qf.shape[3] // cq, kf.shape[2] // ck, causal,
                            cq, ck, q_offset)
        out, lse = _flash_fwd_tiles(qf, kf, vf, bias, pairs, cq, ck,
                                    q_offset, causal, scale)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.meta = (pairs, cq, ck, q_offset, causal, scale)
        o = out.reshape(b, h, qf.shape[3], dh).transpose(1, 2)[:, :sq]
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, out, lse = ctx.saved_tensors
        pairs, cq, ck, q_offset, causal, scale = ctx.meta
        b, sq, h, dh = q.shape
        sk = k.shape[1]
        qf, kf, vf = _pack(q, k, v, cq, ck)
        SQ = qf.shape[3]
        dof = F.pad(do.float().transpose(1, 2), (0, 0, 0, SQ - sq)).reshape(
            qf.shape)
        dq, dk, dv = _flash_bwd_tiles(qf, kf, vf, bias, out, lse, dof, pairs,
                                      cq, ck, q_offset, causal, scale)
        dq = dq.reshape(b, h, SQ, dh).transpose(1, 2)[:, :sq].to(q.dtype)
        dk = dk.transpose(1, 2)[:, :sk].to(k.dtype)
        dv = dv.transpose(1, 2)[:, :sk].to(v.dtype)
        return dq, dk, dv, None, None, None, None, None, None


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, chunk_q: int, chunk_k: int,
                      q_offset: int = 0,
                      lengths: Optional[torch.Tensor] = None,
                      sm_scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention in float32 tiles, O(s * d) memory forward and
    backward: q (b, sq, h, dh); k, v (b, sk, kvh, dh) -> (b, sq, h, dh)
    in q's dtype.  ``q_offset``: the global position of q[0];
    ``lengths``: valid kv lengths (b,)."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    scale = sm_scale if sm_scale is not None else dh ** -0.5
    cq, ck = min(chunk_q, sq), min(chunk_k, sk)
    if lengths is None:
        bias = torch.zeros((b, sk), dtype=torch.float32, device=q.device)
    else:
        bias = torch.where(
            torch.arange(sk, device=q.device)[None, :]
            < lengths[:, None].long(), 0.0, _NEG_INF)
    bias = F.pad(bias, (0, (-sk) % ck), value=_NEG_INF)
    return _Flash.apply(q, k, v, bias, cq, ck, q_offset, causal, scale)


def naive_attention(q, k, v, *, causal, lengths=None, q_offset=0,
                    sm_scale=None) -> torch.Tensor:
    """The reference path (small shapes): the whole score tensor."""
    b, sq, h, dh = q.shape
    _, sk, kvh, _ = k.shape
    g = h // kvh
    scale = sm_scale if sm_scale is not None else dh ** -0.5
    dev = q.device
    qf = q.float().reshape(b, sq, kvh, g, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    kpos = torch.arange(sk, device=dev)
    masked = torch.zeros((b, 1, 1, 1, sk), dtype=torch.bool, device=dev)
    if lengths is not None:
        masked = kpos[None, None, None, None, :] >= \
            lengths.long()[:, None, None, None, None]
    if causal:
        qpos = q_offset + torch.arange(sq, device=dev)
        masked = masked | (kpos[None, None, None, None, :]
                           > qpos[None, None, None, :, None])
    s = s.masked_fill(masked, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, dh).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor,
                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """One-token attention over a dense cache.  q: (b, 1, h, dh); caches:
    (b, S, kvh, dh); lengths: (b,)."""
    b, _, h, dh = q.shape
    _, S, kvh, _ = k_cache.shape
    g = h // kvh
    scale = sm_scale if sm_scale is not None else dh ** -0.5
    qf = (q.float() * scale).reshape(b, kvh, g, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float())
    s = s.masked_fill(_past(lengths, 0, S)[:, None, None, :], _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    out = torch.einsum("bkgs,bskd->bkgd", p / p.sum(dim=-1, keepdim=True),
                       v_cache.float())
    return out.reshape(b, 1, h, dh).to(q.dtype)


def _past(lengths: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    """(b, n) True where cache position ``lo + j`` is at or past a row's
    length (masked)."""
    pos = lo + torch.arange(n, device=lengths.device)
    return pos[None, :] >= lengths.long()[:, None]


def _merged_softmax(s: torch.Tensor, v: torch.Tensor, eq_pv: str, rules
                    ) -> torch.Tensor:
    """Softmax-weighted sum over cache positions split over ``model``:
    ``s`` the (float32, masked) scores of this rank's positions (last
    dim), ``v`` their values.  The max is all-reduced first, then each
    rank's ``sum(p)`` and ``p @ v`` in one sum over ``model``, divided:
    JAX's ``p / l`` form (``decode_attention``, whose ``m`` and ``l``
    GSPMD all-reduces over the sequence shards), summed in another
    order."""
    m = rules.pmax(s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m)
    o = torch.einsum(eq_pv, p, v.float())
    ol = rules.psum(torch.cat([o, p.sum(dim=-1, keepdim=True)], dim=-1))
    return ol[..., :-1] / ol[..., -1:]


def split_decode_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, lengths: torch.Tensor, lo: int,
                           rules) -> torch.Tensor:
    """:func:`decode_attention` over a cache whose positions are split
    over ``model``: ``q`` (b, 1, h, dh) every head, ``k``/``v`` (b, n,
    kvh, dh) this rank's positions ``[lo, lo + n)``; returns every
    head's output."""
    b, _, h, dh = q.shape
    _, n, kvh, _ = k.shape
    qf = (q.float() * dh ** -0.5).reshape(b, kvh, h // kvh, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k.float())
    s = s.masked_fill(_past(lengths, lo, n)[:, None, None, :], _NEG_INF)
    out = _merged_softmax(s, v, "bkgs,bskd->bkgd", rules)
    return out.reshape(b, 1, h, dh).to(q.dtype)


# --------------------------------------------------------------------- #
# GQA layer (train / prefill / decode / cross)
# --------------------------------------------------------------------- #


def _attend(q, k, v, pcfg: ParallelConfig, *, causal, lengths=None,
            q_offset=0):
    if pcfg.attention_impl == "naive":
        return naive_attention(q, k, v, causal=causal, lengths=lengths,
                               q_offset=q_offset)
    return chunked_attention(q, k, v, causal=causal,
                             chunk_q=pcfg.attention_chunk,
                             chunk_k=pcfg.attention_chunk, lengths=lengths,
                             q_offset=q_offset)


def _qkv(cfg: ModelConfig, p, x, positions, *, mode, memory, is_cross,
         use_rope):
    """The projections: q from ``x``; k and v from ``memory`` (cross) or
    ``x``, none for a cross decode (they are its cache); q and a self
    attention's k rotated by ``positions`` (a decode's: the write
    position)."""
    q = torch.einsum("bsd,dhk->bshk", x, cast(p["wq"]))
    k = v = None
    if not (is_cross and mode == "decode"):
        kv_src = memory if is_cross else x
        k = torch.einsum("bsd,dhk->bshk", kv_src, cast(p["wk"]))
        v = torch.einsum("bsd,dhk->bshk", kv_src, cast(p["wv"]))
    if use_rope and not is_cross:
        sin, cos = rope_sincos(positions, cfg.resolved_head_dim,
                               cfg.rope_theta)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    return q, k, v


def _write_kv(cache, k, v, pos):
    """Write (k, v) (b, s, ...) into the (max_len) cache buffers at
    sequence position ``pos``, in place; returns the cache."""
    k_cache, v_cache = cache
    s = k.shape[1]
    k_cache[:, pos:pos + s] = k.to(k_cache.dtype)
    v_cache[:, pos:pos + s] = v.to(v_cache.dtype)
    return k_cache, v_cache


def gqa_attention(cfg: ModelConfig, pcfg: ParallelConfig,
                  p: Dict[str, torch.Tensor], x: torch.Tensor,
                  positions: torch.Tensor, *, mode: str, causal: bool = True,
                  cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  write_pos: Optional[int] = None,
                  lengths: Optional[torch.Tensor] = None,
                  memory: Optional[torch.Tensor] = None,
                  is_cross: bool = False, use_rope: bool = True,
                  rules=None):
    """Returns (out, new_cache).  mode: "train" | "prefill" | "decode".
    ``is_cross``: k/v from ``memory`` at train/prefill (a prefill returns
    them as the new cache), from the cache at decode.  Self-attention
    prefill/decode writes k/v into ``cache`` in place.  ``rules``: the
    rule set's serving layout (:func:`_gqa_rules`)."""
    if rules is not None:
        return _gqa_rules(cfg, pcfg, p, x, positions, mode=mode,
                          causal=causal, cache=cache, write_pos=write_pos,
                          lengths=lengths, memory=memory, is_cross=is_cross,
                          use_rope=use_rope, rules=rules)
    q, k, v = _qkv(cfg, p, x, positions, mode=mode, memory=memory,
                   is_cross=is_cross, use_rope=use_rope)
    new_cache = None
    if is_cross and mode == "decode":
        if cache is None:
            raise ValueError("cross-attention decode needs the memory cache")
        k, v = new_cache = cache
    if is_cross:
        if mode == "decode":
            mem_lengths = torch.full((x.shape[0],), k.shape[1],
                                     dtype=torch.int32, device=x.device)
            out = decode_attention(q, k, v, mem_lengths)
        else:
            out = _attend(q, k, v, pcfg, causal=False)
            if mode == "prefill":
                cdt = cache[0].dtype if cache is not None else k.dtype
                new_cache = (k.to(cdt), v.to(cdt))
    elif mode == "decode":
        if cache is None or write_pos is None:
            raise ValueError("decode needs the cache and write_pos")
        k_cache, v_cache = _write_kv(cache, k, v, write_pos)
        out = decode_attention(q, k_cache, v_cache, lengths)
        new_cache = (k_cache, v_cache)
    else:
        out = _attend(q, k, v, pcfg, causal=causal, lengths=lengths)
        if mode == "prefill" and cache is not None:
            new_cache = _write_kv(cache, k, v, 0)
    out = torch.einsum("bshk,hkd->bsd", out, cast(p["wo"]))
    return out, new_cache


def _kv_for_heads(k, v, h_l: int, g: int, first: int):
    """The KV heads (whole, (b, s, kvh, hd)) that query heads
    ``[first, first + h_l)`` read (head ``i`` reads KV head ``i // g``),
    laid out for them: a run of whole groups, one KV head, or one per
    query head where a block cuts its groups unevenly."""
    if h_l % g == 0 and first % g == 0:
        return k[:, :, first // g:(first + h_l) // g], \
            v[:, :, first // g:(first + h_l) // g]
    if first // g == (first + h_l - 1) // g:
        j = first // g
        return k[:, :, j:j + 1], v[:, :, j:j + 1]
    idx = torch.div(first + torch.arange(h_l, device=k.device), g,
                    rounding_mode="floor")
    return k.index_select(2, idx), v.index_select(2, idx)


def _write_block(cache, k, v, lo: int, start: int, s: int):
    """Write into this rank's cache block, positions ``[lo, lo + n)``,
    those of (k, v) it holds: (k, v) start at global position
    ``start``, and positions from ``s`` on do not exist; in place."""
    k_cache, v_cache = cache
    a = max(lo, start)
    e = min(lo + k_cache.shape[1], start + k.shape[1], s)
    if e > a:
        for dst, src in ((k_cache, k), (v_cache, v)):
            dst[:, a - lo:e - lo] = src[:, a - start:e - start].to(dst.dtype)
    return k_cache, v_cache


def _write_token(cache, k, v, pos: int, lo: int):
    """Write one token's (k, v) (b, 1, ...) at global position ``pos``
    if this rank's block ``[lo, lo + n)`` holds it; in place."""
    k_cache, v_cache = cache
    if lo <= pos < lo + k_cache.shape[1]:
        k_cache[:, pos - lo] = k[:, 0].to(k_cache.dtype)
        v_cache[:, pos - lo] = v[:, 0].to(v_cache.dtype)
    return k_cache, v_cache


def _gqa_rules(cfg: ModelConfig, pcfg: ParallelConfig, p, x, positions, *,
               mode, causal, cache, write_pos, lengths, memory, is_cross,
               use_rope, rules):
    """:func:`gqa_attention` in the rule set's serving layout, on this
    rank's blocks: ``wq``/``wo`` over its heads where the head count
    divides ``model`` (else whole), ``wk``/``wv`` over its KV heads
    where theirs does, each on its own.  Heads whose KV heads are whole
    read them from the whole projections; ``wo``'s partial sums are
    summed over ``model`` only where heads are split.

    The cache holds this rank's block of positions, ``[lo, lo + n)``,
    for every KV head (the sequence over ``model``; the whole sequence
    where its length does not divide).  A prefill writes its positions
    of the new k/v, exchanged over ``model`` first where KV heads are
    split (:meth:`RuleLayout.seq_block`); a decode writes the new token
    on the rank whose block holds ``write_pos``, gathers the query's
    heads, attends over its own positions and merges the partial
    softmax across ``model`` (:func:`split_decode_attention`), keeping
    its heads for ``wo``.  Cross attention's memory cache is split
    likewise on the memory's length.

    Under autograd (train, features; no cache) with heads split, ``x``
    (and a cross attention's memory) enters the rank's heads, and so do
    whole ``wk``/``wv`` whose KV heads the rank's heads take a part of,
    so their gradients are summed over ``model``; with heads whole the
    layer is computed whole on every model rank and sums nothing."""
    H, KVH = cfg.num_heads, cfg.num_kv_heads
    h_l, kvh_l = p["wq"].shape[1], p["wk"].shape[1]
    first = rules.index * h_l if h_l < H else 0
    if h_l < H:
        x, memory = rules.enter(x), rules.enter(memory)
        if kvh_l == KVH:
            p = dict(p, wk=rules.enter(p["wk"]), wv=rules.enter(p["wv"]))
    q, k, v = _qkv(cfg, p, x, positions, mode=mode, memory=memory,
                   is_cross=is_cross, use_rope=use_rope)
    full = rules.enc_len if is_cross else rules.max_len
    lo, n = rules.block(full)
    new_cache = None
    if mode == "decode":
        if cache is None or (write_pos is None and not is_cross):
            raise ValueError("decode needs the cache and write_pos")
        if is_cross:
            lens = torch.full((x.shape[0],), full, dtype=torch.int32,
                              device=x.device)
            new_cache = cache
        else:
            lens = lengths
            new_cache = _write_token(cache, rules.whole(k, 2, KVH),
                                     rules.whole(v, 2, KVH), write_pos, lo)
        kc, vc = new_cache
        if n < full:
            out = split_decode_attention(rules.whole(q, 2, H), kc, vc, lens,
                                         lo, rules)[:, :, first:first + h_l]
        else:
            kk, vv = _kv_for_heads(kc, vc, h_l, H // KVH, first)
            out = decode_attention(q, kk, vv, lens)
    else:
        kk, vv = k, v
        if kvh_l == KVH and h_l < H:
            kk, vv = _kv_for_heads(k, v, h_l, H // KVH, first)
        out = _attend(q, kk, vv, pcfg, causal=causal and not is_cross,
                      lengths=None if is_cross else lengths)
        if mode == "prefill" and cache is not None:
            s_len, start = k.shape[1], 0
            if kvh_l < KVH:       # every KV head of this rank's positions
                k, v = rules.seq_block(k, full), rules.seq_block(v, full)
                start = lo
            if is_cross:          # the memory's block, a new tensor
                if start != lo:
                    k, v = k[:, lo:lo + n], v[:, lo:lo + n]
                new_cache = (k.to(cache[0].dtype), v.to(cache[1].dtype))
            else:
                new_cache = _write_block(cache, k, v, lo, start, s_len)
    out = torch.einsum("bshk,hkd->bsd", out, cast(p["wo"]))
    if h_l < H:
        out = rules.psum(out)
    return out, new_cache


# --------------------------------------------------------------------- #
# MLA layer (DeepSeek-V2)
# --------------------------------------------------------------------- #


def _mla_q(cfg: ModelConfig, p, x, enter=lambda t: t):
    """The queries; ``enter`` takes the replicated input of the
    per-head product (``RuleLayout.enter`` where heads are split)."""
    m = cfg.mla
    if m.q_lora_rank:
        cq = x @ cast(p["wq_a"])
        cq = rmsnorm(cq, p["q_norm"], cfg.norm_eps)
        return torch.einsum("bsr,rhk->bshk", enter(cq), cast(p["wq"]))
    return torch.einsum("bsd,dhk->bshk", enter(x), cast(p["wq"]))


def mla_attention(cfg: ModelConfig, pcfg: ParallelConfig,
                  p: Dict[str, torch.Tensor], x: torch.Tensor,
                  positions: torch.Tensor, *, mode: str,
                  cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  write_pos: Optional[int] = None,
                  lengths: Optional[torch.Tensor] = None, rules=None):
    """MLA: cache = (c_kv (b, S, r), k_rope (b, S, rope_dim)), written in
    place.  Decode runs absorbed (queries pulled into the latent space);
    train and prefill expand the latent to per-head k/v.

    ``rules`` (the rule set's serving layout): ``wq``, ``wk_b``,
    ``wv_b`` and ``wo`` hold this rank's heads where they divide
    ``model``, the latent projections are whole, and the cache holds
    this rank's block of positions (every rank computes the whole
    latent, so a prefill writes its positions with no exchange).  The
    absorbed decode gathers the latent queries' heads, attends over its
    positions, merges across ``model`` and keeps its heads for
    ``wv_b``/``wo``, whose partial sums are summed over ``model``.
    Under autograd with heads split, the whole latents (the queries',
    ``c_kv`` and ``k_rope``) enter the rank's heads, their gradients
    summed over ``model``."""
    m = cfg.mla
    H, h_l = cfg.num_heads, p["wk_b"].shape[1]
    split = rules is not None and h_l < H
    enter = rules.enter if split else (lambda t: t)
    q = _mla_q(cfg, p, x, enter)                    # (b, s, h, nope+rope)
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    ckv_full = x @ cast(p["wkv_a"])
    c_kv, k_rope = (ckv_full[..., :m.kv_lora_rank],
                    ckv_full[..., m.kv_lora_rank:])
    c_kv = rmsnorm(c_kv, p["ckv_norm"], cfg.norm_eps)
    sin, cos = rope_sincos(positions, m.rope_head_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, sin, cos)
    k_rope = apply_rope(k_rope[:, :, None, :], sin, cos)[:, :, 0, :]
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    first = rules.index * h_l if split else 0
    lo, n = rules.block(rules.max_len) if rules is not None else (0, None)

    if mode == "decode" and rules is not None and n < rules.max_len:
        if cache is None or write_pos is None:
            raise ValueError("decode needs the cache and write_pos")
        ckv_cache, krope_cache = _write_token(cache, c_kv, k_rope,
                                              write_pos, lo)
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, cast(p["wk_b"]))
        q_lat, q_rope = rules.whole(q_lat, 2, H), rules.whole(q_rope, 2, H)
        s = (torch.einsum("bshr,bSr->bhS", q_lat.float(), ckv_cache.float())
             + torch.einsum("bshk,bSk->bhS", q_rope.float(),
                            krope_cache.float())) * scale
        s = s.masked_fill(_past(lengths, lo, n)[:, None], _NEG_INF)
        ctx = _merged_softmax(s, ckv_cache, "bhS,bSr->bhr", rules)
        out = torch.einsum("bhr,rhv->bhv", ctx[:, first:first + h_l],
                           cast(p["wv_b"]).float())
        out = out[:, None].to(x.dtype)               # (b, 1, h_l, v)
        new_cache = (ckv_cache, krope_cache)
    elif mode == "decode":
        if cache is None or write_pos is None:
            raise ValueError("decode needs the cache and write_pos")
        ckv_cache, krope_cache = _write_kv(cache, c_kv, k_rope, write_pos)
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, cast(p["wk_b"]))
        s = (torch.einsum("bshr,bSr->bhS", q_lat.float(), ckv_cache.float())
             + torch.einsum("bshk,bSk->bhS", q_rope.float(),
                            krope_cache.float())) * scale
        s = s.masked_fill(_past(lengths, 0, ckv_cache.shape[1])[:, None],
                          _NEG_INF)
        pr = torch.exp(s - s.amax(dim=-1, keepdim=True))
        ctx = torch.einsum("bhS,bSr->bhr", pr / pr.sum(dim=-1, keepdim=True),
                           ckv_cache.float())
        out = torch.einsum("bhr,rhv->bhv", ctx, cast(p["wv_b"]).float())
        out = out[:, None].to(x.dtype)               # (b, 1, h, v)
        new_cache = (ckv_cache, krope_cache)
    else:
        c_kv_h, k_rope_h = enter(c_kv), enter(k_rope)
        k_nope = torch.einsum("bsr,rhk->bshk", c_kv_h, cast(p["wk_b"]))
        vv = torch.einsum("bsr,rhv->bshv", c_kv_h, cast(p["wv_b"]))
        k = torch.cat([k_nope, k_rope_h[:, :, None, :].expand(
            *k_nope.shape[:3], m.rope_head_dim)], dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        # v padded to the qk head dim for the shared helper, then cut
        out = _attend(qq, k, F.pad(vv, (0, k.shape[-1] - vv.shape[-1])),
                      pcfg, causal=True, lengths=lengths)
        out = out[..., :m.v_head_dim]
        new_cache = None
        if mode == "prefill" and cache is not None:
            new_cache = _write_kv(cache, c_kv, k_rope, 0) if rules is None \
                else _write_block(cache, c_kv, k_rope, lo, 0, x.shape[1])
    y = torch.einsum("bshv,hvd->bsd", out, cast(p["wo"]))
    return (rules.psum(y) if split else y), new_cache
