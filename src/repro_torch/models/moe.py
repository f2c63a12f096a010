"""Mixture-of-Experts layer, host-local.

The port's counterpart of the JAX package's ``models/moe.py`` as a
single-device engine runs it: ``moe_layer`` resolves to the exact dense
form (``_dense_moe``, every token through every expert, weighted by its
top-k router probabilities), as the JAX package does whenever no device
mesh is set.  The expert-parallel ``_local_moe`` body and its
``shard_map`` come with tensor-parallel serving.

Routing ties break to the lower expert index, as ``jax.lax.top_k``
breaks them: the top-k is taken from a stable descending sort.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, ParallelConfig
from .layers import cast, gelu, silu
from .params import ParamDef


def moe_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    m = cfg.moe
    d, ff, E = cfg.d_model, m.expert_d_ff, m.num_experts
    defs = {
        "router": ParamDef((d, E), ("embed", None), init="small"),
        "w_gate": ParamDef((E, d, ff), ("experts", "embed", "ff")),
        "w_up": ParamDef((E, d, ff), ("experts", "embed", "ff")),
        "w_down": ParamDef((E, ff, d), ("experts", "ff", "embed")),
    }
    if m.num_shared_experts:
        sff = m.expert_d_ff * m.num_shared_experts
        defs.update({
            "shared_gate": ParamDef((d, sff), ("embed", "ff")),
            "shared_up": ParamDef((d, sff), ("embed", "ff")),
            "shared_down": ParamDef((sff, d), ("ff", "embed")),
        })
    return defs


def _act(g: torch.Tensor, activation: str) -> torch.Tensor:
    return silu(g) if activation == "swiglu" else gelu(g)


def _expert_ffn(w_gate, w_up, w_down, x, activation: str) -> torch.Tensor:
    """x: (E, C, d) through each expert's gated FFN -> (E, C, d)."""
    g = torch.bmm(x, w_gate)
    u = torch.bmm(x, w_up)
    return torch.bmm(_act(g, activation) * u, w_down)


def route(cfg: ModelConfig, router: torch.Tensor, xf: torch.Tensor):
    """Router probabilities and the top-k choice of each token.
    xf: (t, d).  Returns (probs (t, E), top_p (t, k) renormalised,
    top_e (t, k)), in float32."""
    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :cfg.moe.top_k], top_e[:, :cfg.moe.top_k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return probs, top_p, top_e


def _dense_moe(cfg: ModelConfig, p: Dict[str, torch.Tensor],
               x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every token through every expert (exact, no capacity drops).
    Returns (out in x's dtype, the Switch-style aux loss)."""
    m = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    probs, top_p, top_e = route(cfg, p["router"], xf)
    onehot = F.one_hot(top_e, m.num_experts).float()          # (t,k,E)
    me = probs.mean(dim=0)
    ce = onehot.sum(dim=1).mean(dim=0)
    aux = (me * ce).sum() * m.num_experts / m.top_k

    w_gate = cast(p["w_gate"])
    h = _expert_ffn(w_gate, cast(p["w_up"]), cast(p["w_down"]),
                    xf.to(w_gate.dtype).expand(m.num_experts, -1, -1),
                    cfg.activation)                            # (E,t,d)
    gate = (onehot * top_p[..., None]).sum(dim=1)              # (t,E)
    out = torch.einsum("te,etd->td", gate, h.float())
    return out.reshape(b, s, d).to(x.dtype), aux


def moe_layer(cfg: ModelConfig, pcfg: ParallelConfig,
              p: Dict[str, torch.Tensor],
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_loss); the routed experts run densely (see
    the module docstring), the shared experts on every token."""
    del pcfg
    out, aux = _dense_moe(cfg, p, x)
    if cfg.moe.num_shared_experts:
        g = x @ cast(p["shared_gate"])
        u = x @ cast(p["shared_up"])
        out = out + (_act(g, cfg.activation) * u) @ cast(p["shared_down"])
    return out, aux
