"""llama4-scout-17b-a16e — MoE 16e top-1, 48L d5120 40H (GQA kv=8)
expert d_ff 8192; early-fusion frontend stubbed [hf:meta-llama]."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    head_dim=128, d_ff=8192, vocab_size=202_048,
    activation="swiglu", rope_theta=500_000.0,
    moe=MoEConfig(num_experts=16, top_k=1, num_shared_experts=1,
                  expert_d_ff=8192),
)
