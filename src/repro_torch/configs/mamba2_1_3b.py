"""mamba2-1.3b — attention-free SSD: 48L d2048, state 128, headdim 64
[arXiv:2405.21060]."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    head_dim=64, d_ff=0, vocab_size=50_280,
    activation="swiglu", tie_embeddings=True,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256),
    supports_long_context=True,
)
