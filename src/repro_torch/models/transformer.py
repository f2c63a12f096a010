"""Model layout: layer groups and the stacked parameter tree.

The port's counterpart of ``layer_groups`` and ``model_defs`` in the
JAX package's ``models/transformer.py``.  Parameters of a group are
stacked along a leading ``layers`` dim (``group0`` for the decoder-only
families); the serving engine walks that dim with a Python loop where
the JAX package used ``lax.scan``.

Families -> groups (the JAX package's layouts):
  dense          [(L, attn+mlp)]
  moe            [(k, attn+mlp), (L-k, attn+moe)]   (k = first dense)
  ssm            [(L, mamba)]
  hybrid (jamba) [(L/P, superblock of P pairs: attn mixer at index
                  P/2-1, mamba elsewhere; MoE on odd pairs, MLP on even)]
MLA attention and the other families (vlm, encdec) raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from repro_torch.configs.base import ModelConfig
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import embed_defs, mlp_defs, rmsnorm_def
from .params import ParamDef, stacked


def attn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    if cfg.mla is not None:
        raise NotImplementedError("MLA attention is not ported yet")
    d, h, kvh, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
    return {
        "wq": ParamDef((d, h, hd), ("dmodel_rp", "heads", None)),
        "wk": ParamDef((d, kvh, hd), ("dmodel_rp", "kv_heads", None)),
        "wv": ParamDef((d, kvh, hd), ("dmodel_rp", "kv_heads", None)),
        "wo": ParamDef((h, hd, d), ("heads", None, "dmodel_rp")),
    }


def _sublayer_defs(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    d = cfg.d_model
    if kind == "attn":
        return {"norm": rmsnorm_def(d), "attn": attn_defs(cfg)}
    if kind == "mlp":
        return {"norm": rmsnorm_def(d),
                "mlp": mlp_defs(d, cfg.d_ff, cfg.activation)}
    if kind == "mamba":
        return {"norm": rmsnorm_def(d), "ssm": ssm_mod.ssm_defs(cfg)}
    if kind == "moe":
        return {"norm": rmsnorm_def(d), "moe": moe_mod.moe_defs(cfg)}
    raise NotImplementedError(f"sublayer kind {kind!r} is not ported yet")


def _layer_defs(cfg: ModelConfig,
                layer_kind: Tuple[str, ...]) -> Dict[str, Any]:
    return {f"{i}_{k}": _sublayer_defs(cfg, k)
            for i, k in enumerate(layer_kind)}


def layer_groups(cfg: ModelConfig
                 ) -> Tuple[Tuple[int, Tuple[str, ...]], ...]:
    """((count, (sublayer kinds...)), ...) per family, as the JAX
    package lays them out."""
    L = cfg.num_layers
    if cfg.family == "dense":
        return ((L, ("attn", "mlp")),)
    if cfg.family == "moe":
        if cfg.mla is not None:
            raise NotImplementedError("MLA attention is not ported yet")
        k = cfg.moe.first_dense_layers
        groups = [(k, ("attn", "mlp"))] if k else []
        groups.append((L - k, ("attn", "moe")))
        return tuple(groups)
    if cfg.family == "ssm":
        return ((L, ("mamba",)),)
    if cfg.family == "hybrid":
        period = cfg.attn_every
        kinds = []
        for i in range(period):
            mixer = "attn" if i == period // 2 - 1 else "mamba"
            ffn = "moe" if (i % 2 == 1 and cfg.moe) else "mlp"
            kinds.extend([mixer, ffn])
        return ((L // period, tuple(kinds)),)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (dense, moe, ssm and "
        "hybrid are)")


def model_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """The stacked parameter tree (``embed``, ``final_norm``,
    ``group0``, ...), laid out as the JAX package lays it."""
    defs: Dict[str, Any] = {"embed": embed_defs(cfg),
                            "final_norm": rmsnorm_def(cfg.d_model)}
    for gi, (count, kinds) in enumerate(layer_groups(cfg)):
        defs[f"group{gi}"] = stacked(_layer_defs(cfg, kinds), count)
    return defs
