"""Random bf16 weights made from ``--seed``, on the device, in a few
large calls.

The benchmark owns the weights: it draws them here, hands the same
tensors to the program (``system.program_params`` lays them out as the
program's tree, views and no copies) and to the plain reference, which
reads them by the names below.  Every normal leaf is a slice of one
``torch.randn`` over the whole model, scaled in place; the rest are a
few fills.

Names (per layer, stacked over ``L``):

* dense: ``attn_norm (L, d)``, ``wq (L, d, H*hd)``, ``wk``/``wv (L, d,
  kvh*hd)``, ``wo (L, H*hd, d)``, ``mlp_norm (L, d)``, ``w_gate``/``w_up
  (L, d, ff)``, ``w_down (L, ff, d)``;
* ssm: ``norm (L, d)``, ``in_proj (L, d, 2*d_in + 2*N + heads)`` (its
  columns ``[z, x, B, C, dt]``), ``conv_w (L, W, ch)`` over ``[x, B,
  C]``, ``conv_b (L, ch)``, ``a_log``/``dt_bias``/``d_skip (L, heads)``,
  ``out_norm (L, d_in)``, ``out_proj (L, d_in, d)``;
* both: ``embed (V, d)`` (tied: also the output table) and
  ``final_norm (d,)``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from bench.model import Model

EMBED_STD = 0.02
# elements a draw: a few large calls for a whole model
DRAW = 1 << 30


def _normal_leaves(m: Model) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, std) of every normally drawn leaf."""
    L, d = m.layers, m.d_model
    out = [("embed", (m.vocab, d), EMBED_STD)]
    if m.family == "dense":
        q, kv = m.heads * m.head_dim, m.kv_heads * m.head_dim
        out += [("wq", (L, d, q), d ** -0.5), ("wk", (L, d, kv), d ** -0.5),
                ("wv", (L, d, kv), d ** -0.5), ("wo", (L, q, d), q ** -0.5),
                ("w_gate", (L, d, m.d_ff), d ** -0.5),
                ("w_up", (L, d, m.d_ff), d ** -0.5),
                ("w_down", (L, m.d_ff, d), m.d_ff ** -0.5)]
    else:
        s = m.ssm
        width = 2 * s.d_inner + 2 * s.state + s.heads
        out += [("in_proj", (L, d, width), d ** -0.5),
                ("conv_w", (L, s.conv, s.conv_channels), s.conv ** -0.5),
                ("out_proj", (L, s.d_inner, d), s.d_inner ** -0.5)]
    return out


def make(m: Model, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight of ``m`` in bfloat16 on ``device``, drawn from
    ``seed`` by a generator on that device."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed % (1 << 63))
    leaves = _normal_leaves(m)
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    flat = torch.empty(total, dtype=torch.bfloat16, device=dev)
    for at in range(0, total, DRAW):
        flat[at:at + DRAW].normal_(generator=gen)
    w: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, std in leaves:
        n = math.prod(shape)
        w[name] = flat[at:at + n].view(shape).mul_(std)
        at += n
    L, d = m.layers, m.d_model

    def ones(*shape):
        return torch.ones(shape, dtype=torch.bfloat16, device=dev)

    w["final_norm"] = ones(d)
    if m.family == "dense":
        w["attn_norm"] = ones(L, d)
        w["mlp_norm"] = ones(L, d)
        return w
    s = m.ssm
    w["norm"] = ones(L, d)
    w["out_norm"] = ones(L, s.d_inner)
    w["d_skip"] = ones(L, s.heads)
    w["conv_b"] = torch.zeros((L, s.conv_channels), dtype=torch.bfloat16,
                              device=dev)
    u = torch.rand((2, L, s.heads), generator=gen, dtype=torch.float32,
                   device=dev)
    # A in U(1, 16) (the Mamba-2 initialisation), dt log-uniform in
    # [1e-3, 1e-1] and dt_bias its inverse softplus
    w["a_log"] = torch.log(1 + 15 * u[0]).to(torch.bfloat16)
    dt = torch.exp(math.log(1e-3) + u[1] * (math.log(1e-1) - math.log(1e-3)))
    w["dt_bias"] = (dt + torch.log(-torch.expm1(-dt))).to(torch.bfloat16)
    return w
