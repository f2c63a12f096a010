"""Common neural layers: RMSNorm, rotary embeddings, gated MLPs,
embeddings/logits — bf16 compute, as in the JAX package's
``models/layers.py``.

Each function rounds where the JAX version rounds (every elementwise op
on a bf16 tensor yields bf16), so the two packages agree to bf16
tolerance on the same weights.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from .params import ParamDef

COMPUTE_DTYPE = torch.bfloat16


def cast(x: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE_DTYPE)


# ----------------------------- RMSNorm -------------------------------- #


def rmsnorm_def(d: int) -> ParamDef:
    return ParamDef((d,), ("embed",), init="ones")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    # variance in fp32, normalisation applied in the input dtype
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


# ----------------------------- RoPE ----------------------------------- #


def rope_sincos(positions: torch.Tensor, dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (..., s) int -> fp32 sin/cos of shape (..., s, dim//2)."""
    exponent = (torch.arange(0, dim, 2, dtype=torch.float32,
                             device=positions.device) / dim)
    freqs = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: (b, s, h, d); sin/cos: (b, s, d//2) — GPT-NeoX half rotation."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    sin = sin[:, :, None, :].to(x.dtype)
    cos = cos[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ----------------------------- MLP ------------------------------------ #


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * logistic(x)``, the logistic evaluated as
    ``1 / (1 + exp(-x))`` one operation at a time in ``x``'s dtype, as
    XLA evaluates it (on a bf16 input each step rounds to bf16, which
    ``F.silu``'s single rounding does not reproduce)."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh approximation, its default), one
    operation at a time in ``x``'s dtype as XLA evaluates it, for the
    reason :func:`silu` gives; its constants are rounded to that dtype
    first, as JAX rounds a Python scalar to the array's dtype."""
    c = torch.tensor(np.sqrt(2 / np.pi), dtype=x.dtype)
    k = torch.tensor(0.044715, dtype=x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def mlp_defs(d: int, ff: int, activation: str) -> Dict[str, ParamDef]:
    defs = {
        "up": ParamDef((d, ff), ("embed", "ff")),
        "down": ParamDef((ff, d), ("ff", "embed")),
    }
    if activation in ("swiglu", "geglu"):
        defs["gate"] = ParamDef((d, ff), ("embed", "ff"))
    return defs


def mlp(p: Dict[str, torch.Tensor], x: torch.Tensor,
        activation: str, rules=None, d_ff: int = 0) -> torch.Tensor:
    """x: (b, s, d) -> (b, s, d).  With ``rules`` (a
    ``sharding.RuleLayout``) the weights may be this rank's block of a
    ``d_ff`` hidden split over ``model``: ``x`` then enters the rank's
    block (its gradient summed over ``model``) and the down
    projection's partial sums are summed over it (a hidden left whole
    is not)."""
    split = rules is not None and p["down"].shape[0] < d_ff
    if split:
        x = rules.enter(x)
    up = x @ cast(p["up"])
    if activation in ("swiglu", "geglu"):
        gate = x @ cast(p["gate"])
        act = silu(gate) if activation == "swiglu" else gelu(gate)
        h = act * up
    else:
        h = gelu(up)
    out = h @ cast(p["down"])
    return rules.psum(out) if split else out


# ----------------------------- Embedding ------------------------------ #


def embed_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    defs = {"tok": ParamDef((cfg.vocab_size, cfg.d_model),
                            ("vocab", "embed"), init="normal")}
    if not cfg.tie_embeddings:
        defs["out"] = ParamDef((cfg.vocab_size, cfg.d_model),
                               ("vocab", "embed"), init="normal")
    return defs


def embed(p: Dict[str, torch.Tensor], tokens: torch.Tensor,
          cfg: ModelConfig, rules=None) -> torch.Tensor:
    """Token embedding.  With ``rules`` the table may be this rank's
    block of vocab rows ``[index * V_l, (index + 1) * V_l)``: the rank
    holding a token gives its row, the others exact zeros, summed over
    ``model`` (bit for bit the whole table's lookup)."""
    table = p["tok"]
    if rules is not None and table.shape[0] < cfg.vocab_size:
        vloc = table.shape[0]
        local = tokens.long() - rules.index * vloc
        ok = (local >= 0) & (local < vloc)
        x = cast(table[local.clamp(0, vloc - 1)])
        x = rules.psum(x.masked_fill(~ok[..., None], 0))
    else:
        x = cast(table[tokens.long()])
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def logits_out(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
               fp32: bool = True, rules=None) -> torch.Tensor:
    """Logits over the output table; with ``rules`` a table split over
    ``model`` by vocab gives this rank's columns (``x`` entering the
    rank's block), gathered whole."""
    table = p.get("out", p["tok"])
    split = rules is not None and table.shape[0] < cfg.vocab_size
    if split:
        x = rules.enter(x)
    out = x @ cast(table).t()
    out = out.float() if fp32 else out
    return rules.gather(out, -1) if split else out
