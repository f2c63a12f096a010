"""minitron-8b — pruned nemotron: 32L d4096 32H (GQA kv=8) d_ff 16384
[arXiv:2407.14679]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=16384, vocab_size=256_000,
    activation="swiglu", rope_theta=500_000.0,
)
