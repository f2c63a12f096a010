"""The plain reference: the two configurations' forward passes in plain
PyTorch and float32, written from the published descriptions, with no
kernel, cache or batching of the program's.  It imports nothing of the
program and takes only the benchmark's weights (``bench.weights``) and
token ids.

``logits(m, w, seqs, precision=...)`` runs each sequence whole (prompt
and served tokens, teacher-forced) and returns the logits at the
positions that chose each served token.  ``precision="fp8"`` is the
control: every matrix product's operands (weights, activations, and
attention's Q, K and V) rounded to float8 e4m3 with a per-tensor scale
first, the step a lower-precision serving path would take.

``widest_gap`` judges greedy tokens; ``draw_stats`` judges tokens drawn
at temperature 1 by how they fall in the reference's distributions, and
``draw`` makes such tokens (the control's, and the planted faults').

Departures from the published models, the same in the program: Granite
runs without its muP multipliers (embedding, residual, logits) and with
softmax scaled by 1/sqrt(head_dim); RMSNorm's epsilon and the bf16
residual stream of Mamba-2 are as the configuration file states.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from bench.model import Model

FP8_MAX = 448.0
HEADS_AT_ONCE = 8


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (its largest
    magnitude at the format's largest finite value), back in float32."""
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


@contextlib.contextmanager
def full_float32():
    """Float32 products at full precision (no TF32) while inside."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class _Lin:
    """Matrix products ``x @ W`` in float32, operands rounded first by
    ``q`` (identity, or the control's float8).  A layer's weights are
    converted once (:meth:`layer`) and used for every sequence."""

    def __init__(self, q: Callable):
        self.q = q

    def layer(self, w: Dict[str, torch.Tensor], l: int,
              names: Sequence[str]) -> Dict[str, torch.Tensor]:
        return {n: self.q(w[n][l].float()) for n in names}

    def __call__(self, x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
        return self.q(x) @ wt


# ------------------------------ Granite -------------------------------- #


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, the half-split (GPT-NeoX) form, positions 0..S-1.
    x: (S, heads, hd)."""
    S, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, q8) -> torch.Tensor:
    """Causal softmax attention, grouped-query: q (S, H, hd), k and v
    (S, kvh, hd); query head h reads KV head h // (H / kvh)."""
    S, H, hd = q.shape
    g = H // k.shape[1]
    q, k, v = q8(q), q8(k), q8(v)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(q)
    for h0 in range(0, H, HEADS_AT_ONCE):
        hs = range(h0, min(H, h0 + HEADS_AT_ONCE))
        qh = q[:, hs].transpose(0, 1)                          # (h, S, hd)
        kh = k[:, [h // g for h in hs]].transpose(0, 1)
        vh = v[:, [h // g for h in hs]].transpose(0, 1)
        s = (qh @ kh.transpose(1, 2)) / hd ** 0.5
        s = s.masked_fill(~mask, float("-inf"))
        out[:, hs] = (torch.softmax(s, dim=-1) @ vh).transpose(0, 1)
    return out


_GRANITE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _granite_layer(m: Model, w, lw, l: int, x: torch.Tensor,
                   lin) -> torch.Tensor:
    S = x.shape[0]
    H, kvh, hd = m.heads, m.kv_heads, m.head_dim
    h = _rms(x, w["attn_norm"][l], m.norm_eps)
    q = _rope(lin(h, lw["wq"]).view(S, H, hd), m.rope_theta)
    k = _rope(lin(h, lw["wk"]).view(S, kvh, hd), m.rope_theta)
    v = lin(h, lw["wv"]).view(S, kvh, hd)
    o = _attention(q, k, v, lin.q).reshape(S, H * hd)
    x = x + lin(o, lw["wo"])
    h = _rms(x, w["mlp_norm"][l], m.norm_eps)
    return x + lin(_silu(lin(h, lw["w_gate"])) * lin(h, lw["w_up"]),
                   lw["w_down"])


# ------------------------------ Mamba-2 -------------------------------- #


def _ssd(xs, dt, A, B, C) -> torch.Tensor:
    """The SSD recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t,
    y_t = C_t h_t, in its quadratic (attention-like) form:
    y_t = sum_{s<=t} exp(A sum_{r=s+1..t} dt_r) (C_t . B_s) dt_s x_s.
    xs (S, heads, P); dt (S, heads); A (heads,); B, C (S, N)."""
    S, H, P = xs.shape
    cum = torch.cumsum(dt.double() * A.double()[None, :], dim=0)   # (S, H)
    G = C @ B.t()                                                  # (S, S)
    mask = torch.ones((S, S), dtype=torch.bool, device=xs.device).tril()
    y = torch.empty_like(xs)
    for h0 in range(0, H, HEADS_AT_ONCE):
        hs = slice(h0, min(H, h0 + HEADS_AT_ONCE))
        c = cum[:, hs].t()                                         # (h, S)
        seg = (c[:, :, None] - c[:, None, :]).masked_fill(~mask, -float("inf"))
        Mh = torch.exp(seg).float() * G[None] * dt[:, hs].t()[:, None, :]
        y[:, hs] = torch.einsum("hts,shp->thp", Mh, xs[:, hs])
    return y


_MAMBA = ("in_proj", "out_proj")


def _mamba_layer(m: Model, w, lw, l: int, x: torch.Tensor,
                 lin) -> torch.Tensor:
    s = m.ssm
    S = x.shape[0]
    h = _rms(x, w["norm"][l], m.norm_eps)
    zxbcdt = lin(h, lw["in_proj"])
    z, xbc, dt = torch.split(zxbcdt, [s.d_inner, s.conv_channels, s.heads],
                             dim=-1)
    # depthwise causal conv over time: out_t = sum_i w_i x_{t-(W-1)+i} + b
    xp = torch.cat([xbc.new_zeros((s.conv - 1, xbc.shape[1])), xbc])
    cw = w["conv_w"][l].float()
    conv = sum(cw[i] * xp[i:i + S] for i in range(s.conv))
    xbc = _silu(conv + w["conv_b"][l].float())
    xs, B, C = torch.split(xbc, [s.d_inner, s.state, s.state], dim=-1)
    xs = xs.reshape(S, s.heads, s.head_dim)
    dt = torch.nn.functional.softplus(dt + w["dt_bias"][l].float())
    A = -torch.exp(w["a_log"][l].float())
    y = _ssd(xs, dt, A, B, C) + w["d_skip"][l].float()[None, :, None] * xs
    y = y.reshape(S, s.d_inner) * _silu(z)
    return x + lin(_rms(y, w["out_norm"][l], m.norm_eps), lw["out_proj"])


_LAYER = {"dense": (_granite_layer, _GRANITE), "ssm": (_mamba_layer, _MAMBA)}


def logits(m: Model, w: Dict[str, torch.Tensor],
           seqs: Sequence[Tuple[Sequence[int], int]],
           precision: str = "float32") -> List[torch.Tensor]:
    """For each ``(tokens, first)``: the float32 logits (n, vocab) at
    positions ``first .. len(tokens) - 1``, each the distribution over
    the token after it.  ``precision``: "float32" (the reference) or
    "fp8" (the control)."""
    lin = _Lin({"float32": _same, "fp8": _fp8}[precision])
    layer, names = _LAYER[m.family]
    dev = w["embed"].device
    with torch.no_grad(), full_float32():
        xs = [w["embed"][torch.as_tensor(list(t), dtype=torch.long,
                                         device=dev)].float()
              for t, _ in seqs]
        for l in range(m.layers):
            lw = lin.layer(w, l, names)
            xs = [layer(m, w, lw, l, x, lin) for x in xs]
            del lw
        table = lin.q(w["embed"].float()).t()
        return [lin(_rms(x[first:], w["final_norm"], m.norm_eps), table)
                for x, (_, first) in zip(xs, seqs)]


def widest_gap(ref: torch.Tensor, chosen: torch.Tensor) -> float:
    """How far below the reference's best logit the chosen tokens' logits
    lie, at the worst position: ``max_t (max_v ref[t, v] - ref[t,
    chosen[t]])``."""
    best = ref.max(dim=-1).values
    got = ref.gather(1, chosen.view(-1, 1).long().to(ref.device))[:, 0]
    return float((best - got).max())


def draw(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The inverse-CDF draw from ``softmax(logits)`` (token-id order) at
    the uniforms ``u``, one a row."""
    cum = torch.cumsum(torch.softmax(logits.double(), dim=-1), dim=-1)
    u = u.to(cum.device, torch.float64)[:, None]
    return (cum <= u).sum(-1).clamp(max=logits.shape[-1] - 1)


def draw_stats(refs: Sequence[torch.Tensor], chosen: Sequence[torch.Tensor],
               gen: torch.Generator) -> Dict[str, float]:
    """Two tests that tokens were drawn from the reference's
    distributions (``refs``: logits rows, temperature 1), each row given
    the tokens before it:

    * ``nll_z``: the sum over rows of ``-log p(token)`` less the row's
      entropy, over the square root of the summed variances of ``-log
      p``: a z-score, about N(0, 1) for a sound draw (each term has mean
      0 given the rows before it); an argmax choice reads far below 0, a
      draw from another row or a flat draw far above;
    * ``pit_ks``: the randomised probability integral transform of each
      token, ``F(token - 1) + v p(token)`` with ``v`` uniform from
      ``gen``, is uniform on [0, 1) for a sound draw; its Kolmogorov-
      Smirnov distance from uniform, times the square root of the
      number of rows (about 1.36 at the 5% level, 1.95 at 0.1%), sees a
      biased or stuck uniform under the inverse-CDF draw."""
    dz = var = 0.0
    pits = []
    for r, c in zip(refs, chosen):
        lp = torch.log_softmax(r.double(), dim=-1)
        p = lp.exp()
        c = c.view(-1, 1).long().to(r.device)
        pc = p.gather(1, c)[:, 0]
        ent = -(p * lp).sum(-1)
        dz += float((-lp.gather(1, c)[:, 0] - ent).sum())
        var += float(((p * lp.square()).sum(-1) - ent.square()).sum())
        below = torch.cumsum(p, dim=-1).gather(1, c)[:, 0] - pc
        v = torch.rand(len(pc), generator=gen, dtype=torch.float64)
        pits.append((below + v.to(r.device) * pc).clamp(0.0, 1.0).cpu())
    u = torch.cat(pits).sort().values
    n = len(u)
    i = torch.arange(1, n + 1, dtype=torch.float64) / n
    ks = float(torch.maximum(i - u, u - (i - 1.0 / n)).max())
    return {"nll_z": dz / math.sqrt(max(var, 1e-30)),
            "pit_ks": ks * math.sqrt(n), "tokens": n}
