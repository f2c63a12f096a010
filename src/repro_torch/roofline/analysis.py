"""Roofline terms of a step on the port's hardware (``hw``: one H100).

The port's counterpart of the JAX package's ``roofline/analysis.py``.
Three terms per (arch x shape x mesh), all in seconds:

  compute    = FLOPs / (chips x peak)
  memory     = bytes / (chips x HBM bw)
  collective = collective_bytes / (chips x link bw)

:class:`RooflineTerms`, :func:`model_flops`, :func:`num_attn_layers`,
:func:`active_params` and :func:`collective_bytes_total` are the JAX
package's, unchanged.  Its ``parse_collective_bytes`` reads the
compiled HLO text, which PyTorch has no counterpart of: here the
collective bytes come from the mesh that ran them,
:meth:`repro_torch.launch.mesh.Mesh.collective_bytes`, in the same
``{kind: bytes, "_counts": {kind: calls}}`` shape (each call's output
tensor bytes, as the JAX package counts an HLO collective's), which
:func:`collective_bytes_total` takes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.launch.mesh import COLLECTIVES

from . import hw


def collective_bytes_total(parsed: Dict[str, int]) -> int:
    total = 0
    for k in COLLECTIVES:
        mult = 2 if k == "all-reduce" else 1
        total += mult * parsed.get(k, 0)
    return total


@dataclass
class RooflineTerms:
    flops: float                 # per-chip flops
    hbm_bytes: float             # per-chip bytes accessed
    coll_bytes: float            # per-chip collective bytes
    chips: int
    model_flops: float = 0.0     # analytic useful flops (global)

    @property
    def t_compute(self) -> float:
        return self.flops / hw.PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / hw.HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / hw.ICI_LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / total flops (global)."""
        if not self.model_flops:
            return 0.0
        return self.model_flops / (self.flops * self.chips)

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time / bound time."""
        if not self.model_flops:
            return 0.0
        t_useful = self.model_flops / (self.chips * hw.PEAK_FLOPS_BF16)
        return t_useful / self.t_bound if self.t_bound else 0.0

    def as_dict(self) -> Dict:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "collective_bytes_per_chip": self.coll_bytes,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_fraction": self.useful_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(cfg, shape, param_count: int) -> float:
    """Analytic useful FLOPs for the step (6ND for train; 2ND x tokens
    for inference; + attention terms)."""
    n_active = active_params(cfg, param_count)
    hd = cfg.resolved_head_dim

    def attn_flops(tokens: int, kv_len_avg: float) -> float:
        # 2 * (QK^T + PV) = 4 * tokens * kv_len * h * hd  (causal halves it)
        n_attn_layers = num_attn_layers(cfg)
        return 4.0 * tokens * kv_len_avg * cfg.num_heads * hd * n_attn_layers

    if shape.kind == "train":
        base = 6.0 * n_active * shape.tokens
        base += 3.0 * attn_flops(shape.tokens, shape.seq_len / 2)
        return base
    if shape.kind == "prefill":
        return (2.0 * n_active * shape.tokens
                + attn_flops(shape.tokens, shape.seq_len / 2))
    # decode: one token per sequence
    toks = shape.global_batch
    return 2.0 * n_active * toks + attn_flops(toks, shape.seq_len)


def num_attn_layers(cfg) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    if cfg.family == "encdec":
        return cfg.enc_layers + 2 * cfg.dec_layers
    return cfg.num_layers


def active_params(cfg, total: int) -> float:
    """Active parameters per token (MoE: only routed top-k + shared)."""
    if not cfg.moe:
        return float(total)
    m = cfg.moe
    mult = 3 if cfg.activation in ("swiglu", "geglu") else 2
    expert_p = mult * cfg.d_model * m.expert_d_ff
    if cfg.family == "moe":
        n_moe = cfg.num_layers - m.first_dense_layers
    else:  # hybrid: MoE on odd sublayers = half the layers
        n_moe = cfg.num_layers // 2
    inactive = n_moe * (m.num_experts - m.top_k) * expert_p
    return float(total - inactive)
