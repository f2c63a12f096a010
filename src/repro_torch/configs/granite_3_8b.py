"""granite-3-8b — 40L d4096 32H (GQA kv=8) d_ff 12800 vocab 49155
[hf:ibm-granite]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", family="dense",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=12800, vocab_size=49_155,
    activation="swiglu", tie_embeddings=True, rope_theta=10_000.0,
)
