"""Granite (``model_type`` ``granite``): dense grouped-query attention
with rotary embeddings and a SwiGLU MLP, the token table tied to the
output.  The configuration file keeps Hugging Face's ``config.json``
keys.

Departures from the published model, the same in the program: it runs
without its muP multipliers (embedding, residual, logits) and with
softmax scaled by 1/sqrt(head_dim).

Weights (per layer, stacked over ``L``): ``attn_norm (L, d)``, ``wq (L,
d, H*hd)``, ``wk``/``wv (L, d, kvh*hd)``, ``wo (L, H*hd, d)``,
``mlp_norm (L, d)``, ``w_gate``/``w_up (L, d, ff)``, ``w_down (L, ff,
d)``.  Another dense family may import this module's hooks; one that
sets ``SHARES = True`` (``bench.model.draws_shares``) draws each rank's
blocks by :func:`share_leaves` and runs :func:`layer` on them, which
then sums the attention's and the MLP's partial outputs over the ranks.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from bench.model import Model, Ranks
from bench.reference import HEADS_AT_ONCE, all_sum, rms, silu
from bench.weights import ones

# ------------------------------- sizes --------------------------------- #


def attn_params(d: int, heads: int, kv_heads: int, head_dim: int) -> int:
    return d * head_dim * (2 * heads + 2 * kv_heads)


def read(name: str, c: Dict) -> Model:
    d = c["hidden_size"]
    heads = c["num_attention_heads"]
    kv = c["num_key_value_heads"]
    hd = c.get("head_dim", d // heads)
    ff = c["intermediate_size"]
    L, V = c["num_hidden_layers"], c["vocab_size"]
    matmul = attn_params(d, heads, kv, hd) + 3 * d * ff
    return Model(
        name=name, family=c["model_type"], layers=L, d_model=d, vocab=V,
        norm_eps=c["rms_norm_eps"],
        # the tied table once, the layers with their two norms, the
        # final norm
        param_count=V * d + L * (matmul + 2 * d) + d,
        matmul_param_count=L * matmul, attn_layers=L, heads=heads,
        kv_heads=kv, head_dim=hd, d_ff=ff, rope_theta=c["rope_theta"],
        engine=c["engine"], raw=c)


# ------------------------------ weights -------------------------------- #


def share_leaves(m: Model, parts: int) -> List[Tuple[str, Tuple[int, ...],
                                                    float]]:
    """The layers' normal leaves cut into one of ``parts`` blocks as the
    program's tensor-parallel layout cuts them (heads, KV heads and
    ``d_ff``; the whole model at 1); each drawn at the whole leaf's
    scale."""
    if any(n % parts for n in (m.heads, m.kv_heads, m.d_ff)):
        raise ValueError(f"{m.name}: heads {m.heads}, KV heads {m.kv_heads} "
                         f"and d_ff {m.d_ff} do not cut into {parts} shares")
    L, d = m.layers, m.d_model
    q, kv = m.heads * m.head_dim, m.kv_heads * m.head_dim
    qs, kvs, ffs = q // parts, kv // parts, m.d_ff // parts
    return [("wq", (L, d, qs), d ** -0.5), ("wk", (L, d, kvs), d ** -0.5),
            ("wv", (L, d, kvs), d ** -0.5), ("wo", (L, qs, d), q ** -0.5),
            ("w_gate", (L, d, ffs), d ** -0.5),
            ("w_up", (L, d, ffs), d ** -0.5),
            ("w_down", (L, ffs, d), m.d_ff ** -0.5)]


def leaves(m: Model, ranks: Ranks) -> List[Tuple[str, Tuple[int, ...], float]]:
    return share_leaves(m, 1)


def fill(m: Model, w: Dict[str, torch.Tensor], gen: torch.Generator,
         ranks: Ranks) -> None:
    dev = w["embed"].device
    w["attn_norm"] = ones(dev, m.layers, m.d_model)
    w["mlp_norm"] = ones(dev, m.layers, m.d_model)


# ------------------------------ program -------------------------------- #


def program_config(m: Model):
    """The program's ``ModelConfig``."""
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(
        name=m.name, family="dense", num_layers=m.layers,
        d_model=m.d_model, num_heads=m.heads, num_kv_heads=m.kv_heads,
        head_dim=m.head_dim, d_ff=m.d_ff, vocab_size=m.vocab,
        activation="swiglu", norm_eps=m.norm_eps,
        rope_theta=m.rope_theta, tie_embeddings=True)


def program_params(m: Model, w: Dict[str, torch.Tensor],
                   ranks: Ranks) -> Dict:
    """The program's parameter tree over the weights (views; the heads
    as many as the weights hold: all, or this rank's share)."""
    L, d, hd = m.layers, m.d_model, m.head_dim
    group = {
        "0_attn": {"norm": w["attn_norm"], "attn": {
            "wq": w["wq"].view(L, d, -1, hd),
            "wk": w["wk"].view(L, d, -1, hd),
            "wv": w["wv"].view(L, d, -1, hd),
            "wo": w["wo"].view(L, -1, hd, d)}},
        "1_mlp": {"norm": w["mlp_norm"], "mlp": {
            "up": w["w_up"], "gate": w["w_gate"], "down": w["w_down"]}}}
    return {"embed": {"tok": w["embed"]}, "final_norm": w["final_norm"],
            "group0": group}


# ----------------------------- reference ------------------------------- #


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, the half-split (GPT-NeoX) form, positions 0..S-1.
    x: (S, heads, hd)."""
    S, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, q8) -> torch.Tensor:
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


LAYER_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def layer(m: Model, w, lw, l: int, x: torch.Tensor, lin,
          ranks: Ranks) -> torch.Tensor:
    """One layer over the whole model's weights, or over this rank's
    share of the heads and ``d_ff`` (a ``SHARES`` family), the two
    partial outputs then summed over the ranks."""
    S, hd = x.shape[0], m.head_dim
    H, kvh = lw["wq"].shape[-1] // hd, lw["wk"].shape[-1] // hd

    def whole(y: torch.Tensor) -> torch.Tensor:
        return y if H == m.heads else all_sum(y)

    h = rms(x, w["attn_norm"][l], m.norm_eps)
    q = rope(lin(h, lw["wq"]).view(S, H, hd), m.rope_theta)
    k = rope(lin(h, lw["wk"]).view(S, kvh, hd), m.rope_theta)
    v = lin(h, lw["wv"]).view(S, kvh, hd)
    o = attention(q, k, v, lin.q).reshape(S, H * hd)
    x = x + whole(lin(o, lw["wo"]))
    h = rms(x, w["mlp_norm"][l], m.norm_eps)
    return x + whole(lin(silu(lin(h, lw["w_gate"])) * lin(h, lw["w_up"]),
                         lw["w_down"]))
