"""Mamba-2 (SSD, state-space duality) mixer layer.

The port's counterpart of the JAX package's ``models/ssm.py``: the
chunked SSD algorithm (Dao & Gu, 2024, arXiv:2405.21060).  A sequence
is split into chunks of Q tokens; the intra-chunk output uses the
quadratic dual form (a masked (Q, Q) kernel), and the inter-chunk
contribution flows through a per-chunk state recurrence, a Python loop
of length S/Q where the JAX package used ``lax.scan``.  Decode carries
(conv_state, ssm_state) and costs O(1) a token.

The JAX code is plain (no Pallas kernel), so this is plain PyTorch,
except the paged engine's decode (:func:`ssm_decode_rows`), whose SSD
step runs as one hand-written kernel on the state arena's rows.  It
keeps the JAX casts step by step: the projections in bf16, ``dt``,
``A`` and the SSD scan in float32, the ``d_skip`` term in the
activation dtype and the gated RMSNorm on a bf16 product.  Every SSD
contraction is written as two-operand steps, so no (b, Q, Q, h, p)
intermediate is ever formed.  The float32 products run at full float32
only while ``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's
default), as the reference computes them.

Layout: d_inner = expand * d_model, H = d_inner / P heads, state N per
head.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.kernels.ssm_scan import ops as ss_ops
# one token's SSD recurrence (s == 1): (y (b, 1, h, p) float32, new state)
from repro_torch.kernels.ssm_scan.ref import ssd_step as _ssd_step
from .layers import cast, rmsnorm, silu
from .params import ParamDef


def ssm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    nheads = d_in // s.head_dim
    conv_ch = d_in + 2 * s.state_dim
    return {
        # fused in_proj -> [z, x, B, C, dt]
        "in_proj": ParamDef((d, 2 * d_in + 2 * s.state_dim + nheads),
                            ("embed", "ff")),
        "conv_w": ParamDef((s.conv_width, conv_ch), (None, "ff")),
        "conv_b": ParamDef((conv_ch,), ("ff",), init="zeros"),
        "a_log": ParamDef((nheads,), ("heads",), init="zeros"),
        "dt_bias": ParamDef((nheads,), ("heads",), init="zeros"),
        "d_skip": ParamDef((nheads,), ("heads",), init="ones"),
        "out_norm": ParamDef((d_in,), ("ff",), init="ones"),
        "out_proj": ParamDef((d_in, d), ("ff", "embed")),
    }


def _split_in_proj(cfg: ModelConfig, y: torch.Tensor):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    z, xbc, dt = torch.split(y, [d_in, d_in + 2 * s.state_dim, nheads],
                             dim=-1)
    return z, xbc, dt, d_in, nheads


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``log(1 + exp(x))`` as ``logaddexp(x, 0)``
    (``F.softplus`` switches to ``x`` above a threshold instead)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv; returns (out, new_conv_state).

    xbc: (bsz, s, ch); w: (W, ch); conv_state: (bsz, W-1, ch).  The W
    taps are summed one product at a time in the input dtype, rounding
    after each operation as the JAX expression specifies."""
    W = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], W - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    s = xbc.shape[1]
    out = xp[:, 0:s] * w[0][None, None, :]
    for i in range(1, W):
        out = out + xp[:, i:i + s] * w[i][None, None, :]
    out = silu(out + b[None, None, :].to(out.dtype))
    new_state = xp[:, -(W - 1):] if W > 1 else torch.zeros_like(pad)
    return out, new_state


def _ssd_chunked(x, dt, A, B, C, chunk: int, init=None):
    """Chunked SSD: a loop over chunks carrying the inter-chunk state.

    x: (b, s, h, p); dt: (b, s, h); A: (h,) (negative); B, C: (b, s, n).
    ``init`` (b, h, p, n): the carried inter-chunk state (zeros when
    None); a run split at chunk-multiple boundaries with the final
    state fed back as ``init`` replays the same steps.
    Returns y: (b, s, h, p) in x's dtype, final_state: (b, h, p, n)
    float32."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    Q = chunk
    ii = torch.arange(Q, device=x.device)
    tril = (ii[:, None] >= ii[None, :])[None, :, :, None]     # (1,Q,Q,1)
    if init is None:
        state = torch.zeros((b, h, p, n), dtype=torch.float32,
                            device=x.device)
    else:
        state = init.float()
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        xc, dtc = x[:, sl], dt[:, sl]
        Bc, Cc = B[:, sl].float(), C[:, sl].float()
        dA = dtc * A[None, None, :]                            # (b,Q,h)
        cum = torch.cumsum(dA, dim=1)
        seg = cum[:, :, None, :] - cum[:, None, :, :]          # (b,Q,Q,h)
        L = torch.where(tril, torch.exp(seg),
                        torch.zeros((), device=x.device))
        G = torch.einsum("bin,bjn->bij", Cc, Bc)               # (b,Q,Q)
        xdt = xc.float() * dtc[..., None]                      # (b,Q,h,p)
        # intra-chunk: (L * G) first, then one batched product over j
        y = torch.einsum("bijh,bjhp->bihp", L * G[..., None], xdt)
        dfs = torch.exp(cum)                                   # decay from start
        y = y + torch.einsum("bin,bhpn->bihp", Cc, state) * dfs[..., None]
        dte = torch.exp(cum[:, -1:, :] - cum)                  # decay to end
        S_c = torch.einsum("bjhp,bjn->bhpn", xdt * dte[..., None], Bc)
        state = state * torch.exp(cum[:, -1, :])[:, :, None, None] + S_c
        ys.append(y.to(x.dtype))
    y = torch.cat(ys, dim=1)[:, :s]
    return y, state


def _ssm_tail(cfg: ModelConfig, p: Dict[str, torch.Tensor], x, yh, xh, z,
              d_in: int, rules=None) -> torch.Tensor:
    """The skip term, the gated RMSNorm over all ``d_in`` channels and
    the output projection.  With ``rules`` and a rank's block of heads
    (its channels of ``out_norm``/``out_proj``), the sum of squares and
    the projection's partial sums are summed over ``model`` (the sum of
    squares entering the rank's channels again); with every head,
    ``out_norm`` and ``out_proj`` are taken whole."""
    yh = yh.to(x.dtype) + xh * p["d_skip"].to(x.dtype)[None, None, :, None]
    yflat = yh.reshape(*yh.shape[:2], -1)
    yflat = yflat * silu(z.float()).to(yflat.dtype)
    if rules is None or yflat.shape[-1] == d_in:
        norm, proj = p["out_norm"], cast(p["out_proj"])
        if rules is not None:
            norm, proj = rules.whole(norm, 0, d_in), rules.whole(proj, 0, d_in)
        return rmsnorm(yflat, norm, cfg.norm_eps) @ proj
    # the sum is replicated, and each rank's channels then use it
    ss = rules.enter(rules.psum(
        yflat.float().square().sum(dim=-1, keepdim=True)))
    inv = torch.rsqrt(ss / d_in + cfg.norm_eps).to(yflat.dtype)
    yflat = yflat * inv * p["out_norm"].to(yflat.dtype)
    return rules.psum(yflat @ cast(p["out_proj"]))


def ssm_layer(cfg: ModelConfig, pcfg: ParallelConfig,
              p: Dict[str, torch.Tensor], x: torch.Tensor, *, mode: str,
              cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              rules=None):
    """Mamba-2 mixer.  Returns (out, new_cache).

    ``mode``: "decode" (one token against ``cache``), "prefill" (returns
    the final cache) or "train" (no cache).  cache = (conv_state (b, W-1,
    ch), ssm_state (b, h, p, n)).  ``rules``: the rule set's serving
    layout (:func:`_ssm_rules`)."""
    del pcfg     # the JAX package reads its scan-unroll settings here
    if rules is not None:
        return _ssm_rules(cfg, p, x, mode=mode, cache=cache, rules=rules)
    s_cfg = cfg.ssm
    y = x @ cast(p["in_proj"])
    z, xbc, dt, d_in, nheads = _split_in_proj(cfg, y)
    dt = _softplus(dt.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["a_log"].float())
    split = [d_in, s_cfg.state_dim, s_cfg.state_dim]

    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs the (conv, ssm) cache")
        conv_state, ssm_state = cache
        xbc_conv, new_conv = _causal_conv(xbc, cast(p["conv_w"]),
                                          p["conv_b"], conv_state)
        xx, B, C = torch.split(xbc_conv, split, dim=-1)
        xh = xx.reshape(*xx.shape[:2], nheads, s_cfg.head_dim)
        yh, new_state = _ssd_step(xh, dt, A, B, C, ssm_state)
        new_cache = (new_conv.to(conv_state.dtype),
                     new_state.to(ssm_state.dtype))
    else:
        xbc_conv, new_conv = _causal_conv(xbc, cast(p["conv_w"]),
                                          p["conv_b"])
        xx, B, C = torch.split(xbc_conv, split, dim=-1)
        xh = xx.reshape(*xx.shape[:2], nheads, s_cfg.head_dim)
        yh, final = _ssd_chunked(xh, dt, A, B, C, s_cfg.chunk_size)
        new_cache = (new_conv, final) if mode == "prefill" else None

    return _ssm_tail(cfg, p, x, yh, xh, z, d_in), new_cache


def ssm_decode_rows(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                    x: torch.Tensor, *, conv_state: torch.Tensor,
                    arena: torch.Tensor, rows: torch.Tensor,
                    rowmap: torch.Tensor, alive: Optional[torch.Tensor],
                    out: torch.Tensor):
    """:func:`ssm_layer`'s decode with the SSD state in an arena: the
    paged engine's decode entry point.  The SSD step reads each row's
    state from ``arena`` (one sublayer's (R, h, p, n) rows) at ``rows``
    and writes the new state into ``out`` folded by ``rowmap`` (a dead
    row's, ``alive`` False, left as it was), in one ``ssd_step`` launch
    on the card (:func:`ss_ops.ssd_step_rows`); the conv window is the
    caller's to fold.

    x: (Bp, 1, d); conv_state: (Bp, W-1, ch), the rows' gathered windows.
    Returns (out (Bp, 1, d), the new conv windows in the input's
    dtype)."""
    s_cfg = cfg.ssm
    y = x @ cast(p["in_proj"])
    z, xbc, dt, d_in, nheads = _split_in_proj(cfg, y)
    dt = _softplus(dt.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["a_log"].float())
    xbc_conv, new_conv = _causal_conv(xbc, cast(p["conv_w"]), p["conv_b"],
                                      conv_state)
    xx, B, C = torch.split(xbc_conv, [d_in, s_cfg.state_dim,
                                      s_cfg.state_dim], dim=-1)
    xh = xx.reshape(*xx.shape[:2], nheads, s_cfg.head_dim)
    yh = ss_ops.ssd_step_rows(arena, rows, rowmap, alive, xh[:, 0], dt[:, 0],
                              A, B[:, 0], C[:, 0], out)
    return _ssm_tail(cfg, p, x, yh[:, None], xh, z, d_in), new_conv


def _ssm_rules(cfg: ModelConfig, p: Dict[str, torch.Tensor],
               x: torch.Tensor, *, mode: str, cache, rules):
    """:func:`ssm_layer` on this rank's blocks in the rule set's serving
    layout.  ``in_proj``'s packed columns ``[z, x, B, C, dt]``,
    ``conv_w``/``conv_b`` (over ``[x, B, C]``), ``out_norm`` and
    ``out_proj`` are cut contiguously over ``model`` where their dims
    divide it (the ``ff`` rule), ``a_log``/``dt_bias``/``d_skip`` by
    heads, and the cache's SSM state by heads (``cache_pspecs`` puts
    ``model`` on dim 2 of a 5-D leaf) while its conv state is whole over
    ``model``.  A rank's ``in_proj`` columns do not line up with the
    components, so its product is gathered whole over ``model`` and cut
    again: each rank runs the conv over its heads' x channels and the
    shared B and C, the SSD over its heads (the SSM state's block), and
    the gated norm over its channels with the sum of squares summed
    over ``model``; ``out_proj``'s partial sums are summed over it.  The
    conv state, whole, is written alike by every ``model`` rank.  Under
    autograd ``x`` enters ``in_proj``'s column block, and with heads
    split the gathered product and the whole conv weights enter the
    rank's heads (their gradients summed over ``model``, the gather's
    backward keeping the rank's block)."""
    s_cfg = cfg.ssm
    d_in = s_cfg.expand * cfg.d_model
    nheads, P, N = d_in // s_cfg.head_dim, s_cfg.head_dim, s_cfg.state_dim
    ch = d_in + 2 * N
    W = s_cfg.conv_width
    h_l = p["a_log"].shape[0]
    split = h_l < nheads
    enter = rules.enter if split else (lambda t: t)
    width = 2 * d_in + 2 * N + nheads
    if p["in_proj"].shape[1] < width:      # x enters the rank's columns
        x = rules.enter(x)
    y = enter(rules.whole(x @ cast(p["in_proj"]), -1, width))
    z, xbc, dt = torch.split(y, [d_in, ch, nheads], dim=-1)
    h0 = rules.index * h_l if split else 0
    c0, c1 = h0 * P, (h0 + h_l) * P
    conv_w = enter(rules.whole(cast(p["conv_w"]), 1, ch))
    conv_b = enter(rules.whole(p["conv_b"], 0, ch))
    if mode == "decode" and cache is None:
        raise ValueError("decode needs the (conv, ssm) cache")
    conv_state = cache[0] if mode == "decode" else None
    # the whole conv window for the next call, the same on every rank
    pad = (conv_state.to(xbc.dtype) if conv_state is not None else
           xbc.new_zeros((xbc.shape[0], W - 1, ch)))
    new_conv = torch.cat([pad, xbc], dim=1)[:, xbc.shape[1]:]
    if split:               # this rank's heads' x channels, and B, C
        sel = torch.cat([torch.arange(c0, c1, device=x.device),
                         torch.arange(d_in, ch, device=x.device)])
        xbc, conv_w, conv_b = (xbc.index_select(-1, sel),
                               conv_w.index_select(1, sel),
                               conv_b.index_select(0, sel))
        pad = pad.index_select(-1, sel)
        z = z[..., c0:c1]
    xbc_conv, _ = _causal_conv(xbc, conv_w, conv_b,
                               pad if conv_state is not None else None)
    dt = _softplus(dt[..., h0:h0 + h_l].float()
                   + p["dt_bias"][None, None, :])
    A = -torch.exp(p["a_log"].float())
    xx, B, C = torch.split(xbc_conv, [h_l * P, N, N], dim=-1)
    xh = xx.reshape(*xx.shape[:2], h_l, P)
    if mode == "decode":
        yh, new_state = _ssd_step(xh, dt, A, B, C, cache[1])
        new_cache = (new_conv.to(conv_state.dtype),
                     new_state.to(cache[1].dtype))
    else:
        yh, final = _ssd_chunked(xh, dt, A, B, C, s_cfg.chunk_size)
        new_cache = (new_conv, final) if mode == "prefill" else None
    return _ssm_tail(cfg, p, x, yh, xh, z, d_in, rules), new_cache


def ssm_layer_paged(cfg: ModelConfig, pcfg: ParallelConfig,
                    p: Dict[str, torch.Tensor], x: torch.Tensor, *,
                    lengths: torch.Tensor, conv_state: torch.Tensor,
                    ssm_state: torch.Tensor):
    """Length-masked Mamba-2 prefill over a padded batch with carried
    state: the paged engine's fused-prefill and chunk entry point.

    Positions >= lengths[b] contribute nothing to the recurrence: their
    dt is zeroed after softplus, so the decay is exp(0) = 1 and the
    input term vanishes, and each row's state passes its pad tail
    unchanged.  The new conv window is gathered at each row's true tail.
    Chunked callers split at multiples of ``cfg.ssm.chunk_size`` (the
    engine enforces it).

    x: (b, s, d); lengths: (b,); conv_state: (b, W-1, ch); ssm_state:
    (b, h, p, n).  Returns (out, (new_conv, new_state))."""
    del pcfg
    s_cfg = cfg.ssm
    y = x @ cast(p["in_proj"])
    z, xbc, dt, d_in, nheads = _split_in_proj(cfg, y)
    dt = _softplus(dt.float() + p["dt_bias"][None, None, :])
    pos = torch.arange(x.shape[1], device=x.device)
    valid = pos[None, :] < lengths.long()[:, None]             # (b,s)
    dt = torch.where(valid[:, :, None], dt, torch.zeros((), device=x.device))
    A = -torch.exp(p["a_log"].float())

    W = s_cfg.conv_width
    xbc_conv, _ = _causal_conv(xbc, cast(p["conv_w"]), p["conv_b"],
                               conv_state)
    # the window for the next call: the last W-1 valid inputs of each
    # row (prompt position t sits at index t + W-1 of the padded stream)
    xp = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
    idx = (lengths.long()[:, None]
           + torch.arange(W - 1, device=x.device)[None, :])   # (b,W-1)
    new_conv = torch.gather(
        xp, 1, idx[:, :, None].expand(-1, -1, xp.shape[2]))
    new_conv = new_conv.to(conv_state.dtype)

    xx, B, C = torch.split(xbc_conv, [d_in, s_cfg.state_dim,
                                      s_cfg.state_dim], dim=-1)
    xh = xx.reshape(*xx.shape[:2], nheads, s_cfg.head_dim)
    yh, final = _ssd_chunked(xh, dt, A, B, C, s_cfg.chunk_size,
                             init=ssm_state)
    out = _ssm_tail(cfg, p, x, yh, xh, z, d_in)
    return out, (new_conv, final.to(ssm_state.dtype))
