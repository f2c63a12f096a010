"""gemma-2b — 18L d2048 8H (MQA kv=1) d_ff 16384 GeGLU head_dim 256
[arXiv:2403.08295]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
    head_dim=256, d_ff=16384, vocab_size=256_000,
    activation="geglu", tie_embeddings=True, rope_theta=10_000.0,
)
