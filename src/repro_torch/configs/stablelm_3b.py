"""stablelm-3b — 32L d2560 32H (MHA kv=32) d_ff 6912 vocab 50304
[hf:stabilityai]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    num_layers=32, d_model=2560, num_heads=32, num_kv_heads=32,
    head_dim=80, d_ff=6912, vocab_size=50_304,
    activation="swiglu", rope_theta=10_000.0,
)
