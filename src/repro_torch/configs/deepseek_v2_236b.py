"""deepseek-v2-236b — 60L d5120 128H MLA kv_lora 512, MoE 160e top-6 +
2 shared, expert d_ff 1536, first layer dense [arXiv:2405.04434]."""
from .base import ModelConfig, MLAConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
    head_dim=128, d_ff=12288, vocab_size=102_400,
    activation="swiglu", rope_theta=10_000.0,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, num_shared_experts=2,
                  expert_d_ff=1536, first_dense_layers=1),
)
