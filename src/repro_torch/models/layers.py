"""Common neural layers: RMSNorm, rotary embeddings, gated MLPs,
embeddings/logits — bf16 compute, as in the JAX package's
``models/layers.py``.

Each function rounds where the JAX version rounds (every elementwise op
on a bf16 tensor yields bf16), so the two packages agree to bf16
tolerance on the same weights.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

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


def mlp_defs(d: int, ff: int, activation: str) -> Dict[str, ParamDef]:
    defs = {
        "up": ParamDef((d, ff), ("embed", "ff")),
        "down": ParamDef((ff, d), ("ff", "embed")),
    }
    if activation in ("swiglu", "geglu"):
        defs["gate"] = ParamDef((d, ff), ("embed", "ff"))
    return defs


def mlp(p: Dict[str, torch.Tensor], x: torch.Tensor,
        activation: str) -> torch.Tensor:
    """x: (b, s, d) -> (b, s, d)."""
    up = x @ cast(p["up"])
    if activation in ("swiglu", "geglu"):
        gate = x @ cast(p["gate"])
        # jax.nn.gelu defaults to the tanh approximation
        act = (F.silu(gate) if activation == "swiglu"
               else F.gelu(gate, approximate="tanh"))
        h = act * up
    else:
        h = F.gelu(up, approximate="tanh")
    return h @ cast(p["down"])


# ----------------------------- Embedding ------------------------------ #


def embed_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    defs = {"tok": ParamDef((cfg.vocab_size, cfg.d_model),
                            ("vocab", "embed"), init="normal")}
    if not cfg.tie_embeddings:
        defs["out"] = ParamDef((cfg.vocab_size, cfg.d_model),
                               ("vocab", "embed"), init="normal")
    return defs


def embed(p: Dict[str, torch.Tensor], tokens: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    x = cast(p["tok"][tokens.long()])
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def logits_out(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
               fp32: bool = True) -> torch.Tensor:
    table = p.get("out", p["tok"])
    out = x @ cast(table).t()
    return out.float() if fp32 else out
