"""Config system: model architecture, input shapes, parallelism, run.

A copy of the JAX package's ``configs/base.py`` (the port imports
nothing of that package).  Plain frozen dataclasses (serializable,
hashable where needed).  Every assigned architecture is a `ModelConfig`
in its own module under `repro_torch.configs`; shapes are global
(`SHAPES`) with per-arch applicability resolved by `cells_for(arch)`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


# --------------------------------------------------------------------- #
# Model architecture
# --------------------------------------------------------------------- #


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 1
    num_shared_experts: int = 0
    expert_d_ff: int = 0             # per-expert hidden size
    first_dense_layers: int = 0      # leading layers use dense FFN
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0             # 0 = no q compression
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128             # N (SSD state size)
    head_dim: int = 64               # P
    expand: int = 2                  # d_inner = expand * d_model
    conv_width: int = 4
    chunk_size: int = 256            # SSD chunked-scan block


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    activation: str = "swiglu"       # swiglu | geglu | gelu
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # family extensions
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0              # hybrid: 1 attention layer per N layers
    enc_layers: int = 0              # encdec
    dec_layers: int = 0
    num_patch_tokens: int = 0        # vlm/audio stub frontend tokens
    frontend_dim: int = 0            # stub embedding dim (0 -> d_model)
    # long-context capability (sub-quadratic decode memory/time)
    supports_long_context: bool = False
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_encdec(self) -> bool:
        return self.family == "encdec"

    def param_count(self) -> int:
        """Total parameters (analytic; validated against init in tests)."""
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            if self.mla:
                m = self.mla
                q = d * self.num_heads * (m.nope_head_dim + m.rope_head_dim)
                if m.q_lora_rank:
                    q = d * m.q_lora_rank + m.q_lora_rank * self.num_heads * (
                        m.nope_head_dim + m.rope_head_dim)
                kv_a = d * (m.kv_lora_rank + m.rope_head_dim)
                kv_b = m.kv_lora_rank * self.num_heads * (m.nope_head_dim + m.v_head_dim)
                o = self.num_heads * m.v_head_dim * d
                return q + kv_a + kv_b + o
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            return q + kv + o

        def ffn_params(ff: int) -> int:
            mult = 3 if self.activation in ("swiglu", "geglu") else 2
            return mult * d * ff

        def ssm_params() -> int:
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            in_proj = d * (2 * d_in + 2 * s.state_dim + nheads)
            conv = (d_in + 2 * s.state_dim) * s.conv_width
            out = d_in * d
            return in_proj + conv + out + 2 * nheads  # + A, D

        total = emb
        if self.family == "ssm":
            total += L * (ssm_params() + d)  # + norm
        elif self.family == "hybrid":
            n_attn = L // self.attn_every
            n_ssm = L - n_attn
            moe_ffn = self.moe.num_experts * ffn_params(self.moe.expert_d_ff) if self.moe else 0
            # jamba: alternate MoE / dense MLP every other layer
            n_moe = L // 2
            n_dense = L - n_moe
            total += n_attn * attn_params() + n_ssm * ssm_params()
            total += n_moe * (self.moe.num_experts * ffn_params(self.moe.expert_d_ff)
                              + self.d_model * self.moe.num_experts) if self.moe else 0
            total += n_dense * ffn_params(self.d_ff)
            total += L * 2 * d
        elif self.family == "moe":
            n_dense = self.moe.first_dense_layers
            n_moe = L - n_dense
            router = d * self.moe.num_experts
            experts = self.moe.num_experts * ffn_params(self.moe.expert_d_ff)
            shared = self.moe.num_shared_experts * ffn_params(self.moe.expert_d_ff)
            total += L * attn_params() + L * 2 * d
            total += n_dense * ffn_params(self.d_ff) + n_moe * (experts + shared + router)
        elif self.family == "encdec":
            enc = self.enc_layers * (attn_params() + ffn_params(self.d_ff) + 2 * d)
            dec = self.dec_layers * (2 * attn_params() + ffn_params(self.d_ff) + 3 * d)
            total += enc + dec
        else:  # dense / vlm
            total += L * (attn_params() + ffn_params(self.d_ff) + 2 * d)
        return total


# --------------------------------------------------------------------- #
# Input shapes (assigned set)
# --------------------------------------------------------------------- #


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cells_for(model: ModelConfig) -> List[ShapeConfig]:
    """Applicable (arch x shape) cells; long_500k only for sub-quadratic
    archs (DESIGN.md SS6)."""
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and not model.supports_long_context:
            continue
        out.append(s)
    return out


# --------------------------------------------------------------------- #
# Parallelism / run
# --------------------------------------------------------------------- #


@dataclass(frozen=True)
class ParallelConfig:
    multi_pod: bool = False
    fsdp: bool = True                # ZeRO-3 param/optimizer sharding on data
    remat: str = "full"              # full | dots | none
    attention_impl: str = "chunked"  # chunked | pallas | naive
    attention_chunk: int = 1024
    seq_shard_attention: bool = False  # shard q-seq instead of heads (hillclimb)
    moe_impl: str = "shard_map"      # shard_map | dense
    grad_compression: bool = False   # int8 chunked reduce-scatter
    opt_state_dtype: str = "float32"
    param_dtype: str = "float32"     # master params (bf16 for 200B+ configs)
    microbatches: int = 1
    # cost-analysis lowering: fully unroll layer/tile scans so
    # compiled.cost_analysis() counts every iteration (HLO while bodies
    # are otherwise counted once). Never used for the memory-proof
    # lowering or real runs.
    scan_unroll: bool = False
    # SSD chunk-scan unroll for the cost lowering: 0 = follow scan_unroll
    # (full unroll); k > 0 = partial unroll (cost then extrapolated
    # affinely in k — see dryrun.cost_metrics_extrapolated).
    ssd_unroll: int = 0
    # hillclimb knobs
    logits_fp32: bool = True
    embed_2d_sharding: bool = False
    kv_cache_dtype: str = "bfloat16"   # bfloat16 | float8_e4m3fn (decode)
    moe_psum_dtype: str = "float32"    # bfloat16 halves the EP combine bytes
    row_parallel_attn: bool = False    # shard attn d_model dim over model
    moe_capacity_factor: float = 0.0   # 0 = use the model's own


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"              # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    parallel: ParallelConfig = ParallelConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    seed: int = 0

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


def reduced(model: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test-sized model of the same family (tiny dims, few layers,
    few experts, small vocab) preserving every structural feature."""
    kw: dict = dict(
        num_layers=min(model.num_layers, 4),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(model.num_kv_heads, 4) if model.num_kv_heads > 1 else 1,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
    )
    if model.moe:
        kw["moe"] = dataclasses.replace(
            model.moe, num_experts=min(model.moe.num_experts, 8),
            expert_d_ff=128,
            first_dense_layers=min(model.moe.first_dense_layers, 1))
    if model.mla:
        kw["mla"] = MLAConfig(kv_lora_rank=64, q_lora_rank=0, rope_head_dim=16,
                              nope_head_dim=32, v_head_dim=32)
    if model.ssm:
        kw["ssm"] = dataclasses.replace(model.ssm, state_dim=32, head_dim=16,
                                        chunk_size=32)
    if model.family == "hybrid":
        kw["num_layers"] = 8
        kw["attn_every"] = model.attn_every
    if model.is_encdec:
        kw["enc_layers"] = 2
        kw["dec_layers"] = 2
        kw["num_layers"] = 4
    if model.num_patch_tokens:
        kw["num_patch_tokens"] = 16
    kw.update(overrides)
    return dataclasses.replace(model, **kw)
