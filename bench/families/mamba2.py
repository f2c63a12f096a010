"""Mamba-2 (``model_type`` ``mamba2``): attention-free SSD layers (a
gated in-projection, a depthwise causal conv, the SSD recurrence, a
gated RMSNorm and an out-projection), the token table tied to the
output.  The configuration file keeps ``MambaConfig``'s keys, with the
layer's under ``ssm_cfg``.

Departures from the published model, the same in the program: the
residual stream is bf16 (``residual_in_fp32`` false, as the
configuration file states).

Weights (per layer, stacked over ``L``): ``norm (L, d)``, ``in_proj (L,
d, 2*d_in + 2*N + heads)`` (its columns ``[z, x, B, C, dt]``), ``conv_w
(L, W, ch)`` over ``[x, B, C]``, ``conv_b (L, ch)``,
``a_log``/``dt_bias``/``d_skip (L, heads)``, ``out_norm (L, d_in)``,
``out_proj (L, d_in, d)``.  A hybrid family may import this module's
hooks for its SSM layers.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from bench.model import SSM, Model, Ranks
from bench.reference import HEADS_AT_ONCE, rms, silu
from bench.weights import ones

# ------------------------------- sizes --------------------------------- #


def read_ssm(d: int, s: Dict) -> SSM:
    """The SSM layer's sizes from a ``ssm_cfg`` group."""
    d_in = s["expand"] * d
    return SSM(state=s["d_state"], head_dim=s["headdim"], expand=s["expand"],
               conv=s["d_conv"], chunk=s["chunk_size"], d_inner=d_in,
               heads=d_in // s["headdim"])


def in_proj_width(s: SSM) -> int:
    return 2 * s.d_inner + 2 * s.state + s.heads


def ssm_matmul_params(d: int, s: SSM) -> int:
    """A layer's projections: in_proj and out_proj."""
    return d * in_proj_width(s) + s.d_inner * d


def ssm_layer_params(d: int, s: SSM) -> int:
    """A layer's parameters, its norm included: the projections, the
    conv taps and bias, A, dt bias and D, the gated norm."""
    conv = (s.conv + 1) * s.conv_channels
    return ssm_matmul_params(d, s) + conv + 3 * s.heads + s.d_inner + d


def read(name: str, c: Dict) -> Model:
    d = c["d_model"]
    ssm = read_ssm(d, c["ssm_cfg"])
    L = c["n_layer"]
    # the tied table's rows: the vocabulary padded as the checkpoint pads it
    pad = c.get("pad_vocab_size_multiple", 1)
    vocab = -(-c["vocab_size"] // pad) * pad
    return Model(name=name, family=c["model_type"], layers=L, d_model=d,
                 vocab=vocab, norm_eps=c["norm_epsilon"],
                 param_count=vocab * d + L * ssm_layer_params(d, ssm) + d,
                 matmul_param_count=L * ssm_matmul_params(d, ssm),
                 ssm_layers=L, ssm=ssm, engine=c["engine"], raw=c)


# ------------------------------ weights -------------------------------- #


def leaves(m: Model, ranks: Ranks) -> List[Tuple[str, Tuple[int, ...], float]]:
    L, d, s = m.layers, m.d_model, m.ssm
    return [("in_proj", (L, d, in_proj_width(s)), d ** -0.5),
            ("conv_w", (L, s.conv, s.conv_channels), s.conv ** -0.5),
            ("out_proj", (L, s.d_inner, d), s.d_inner ** -0.5)]


def fill(m: Model, w: Dict[str, torch.Tensor], gen: torch.Generator,
         ranks: Ranks) -> None:
    L, s = m.layers, m.ssm
    dev = w["embed"].device
    w["norm"] = ones(dev, L, m.d_model)
    w["out_norm"] = ones(dev, L, s.d_inner)
    w["d_skip"] = ones(dev, L, s.heads)
    w["conv_b"] = torch.zeros((L, s.conv_channels), dtype=torch.bfloat16,
                              device=dev)
    u = torch.rand((2, L, s.heads), generator=gen, dtype=torch.float32,
                   device=dev)
    # A in U(1, 16) (the Mamba-2 initialisation), dt log-uniform in
    # [1e-3, 1e-1] and dt_bias its inverse softplus
    w["a_log"] = torch.log(1 + 15 * u[0]).to(torch.bfloat16)
    dt = torch.exp(math.log(1e-3) + u[1] * (math.log(1e-1) - math.log(1e-3)))
    w["dt_bias"] = (dt + torch.log(-torch.expm1(-dt))).to(torch.bfloat16)


# ------------------------------ program -------------------------------- #


def program_config(m: Model):
    """The program's ``ModelConfig``."""
    from repro_torch.configs.base import ModelConfig, SSMConfig

    s = m.ssm
    # an attention-free model has no KV heads; the engine still keeps a
    # full-depth KV arena for it, sized by these fields alone
    kv = m.raw["phantom_kv"]
    return ModelConfig(
        name=m.name, family="ssm", num_layers=m.layers, d_model=m.d_model,
        num_heads=kv["num_kv_heads"], num_kv_heads=kv["num_kv_heads"],
        head_dim=kv["head_dim"], d_ff=0, vocab_size=m.vocab,
        activation="swiglu", norm_eps=m.norm_eps, tie_embeddings=True,
        ssm=SSMConfig(state_dim=s.state, head_dim=s.head_dim,
                      expand=s.expand, conv_width=s.conv,
                      chunk_size=s.chunk),
        supports_long_context=True)


SSM_WEIGHTS = ("in_proj", "conv_w", "conv_b", "a_log", "dt_bias", "d_skip",
               "out_norm", "out_proj")


def program_params(m: Model, w: Dict[str, torch.Tensor],
                   ranks: Ranks) -> Dict:
    """The program's parameter tree over the weights (views)."""
    group = {"0_mamba": {"norm": w["norm"],
                         "ssm": {k: w[k] for k in SSM_WEIGHTS}}}
    return {"embed": {"tok": w["embed"]}, "final_norm": w["final_norm"],
            "group0": group}


# ----------------------------- reference ------------------------------- #


def ssd(xs, dt, A, B, C) -> torch.Tensor:
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


LAYER_WEIGHTS = ("in_proj", "out_proj")


def layer(m: Model, w, lw, l: int, x: torch.Tensor, lin,
          ranks: Ranks) -> torch.Tensor:
    s = m.ssm
    S = x.shape[0]
    h = rms(x, w["norm"][l], m.norm_eps)
    zxbcdt = lin(h, lw["in_proj"])
    z, xbc, dt = torch.split(zxbcdt, [s.d_inner, s.conv_channels, s.heads],
                             dim=-1)
    # depthwise causal conv over time: out_t = sum_i w_i x_{t-(W-1)+i} + b
    xp = torch.cat([xbc.new_zeros((s.conv - 1, xbc.shape[1])), xbc])
    cw = w["conv_w"][l].float()
    conv = sum(cw[i] * xp[i:i + S] for i in range(s.conv))
    xbc = silu(conv + w["conv_b"][l].float())
    xs, B, C = torch.split(xbc, [s.d_inner, s.state, s.state], dim=-1)
    xs = xs.reshape(S, s.heads, s.head_dim)
    dt = torch.nn.functional.softplus(dt + w["dt_bias"][l].float())
    A = -torch.exp(w["a_log"][l].float())
    y = ssd(xs, dt, A, B, C) + w["d_skip"][l].float()[None, :, None] * xs
    y = y.reshape(S, s.d_inner) * silu(z)
    return x + lin(rms(y, w["out_norm"][l], m.norm_eps), lw["out_proj"])
