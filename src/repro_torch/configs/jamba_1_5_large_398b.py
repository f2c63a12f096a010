"""jamba-1.5-large-398b — hybrid Mamba+attn 1:7, 72L d8192 64H (GQA kv=8),
MoE 16e top-2 every other layer [arXiv:2403.19887]."""
from .base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=24576, vocab_size=65_536,
    activation="swiglu", attn_every=8,
    moe=MoEConfig(num_experts=16, top_k=2, expert_d_ff=24576),
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256),
    supports_long_context=True,   # 1:7 attention; Mamba layers O(1) state
)
