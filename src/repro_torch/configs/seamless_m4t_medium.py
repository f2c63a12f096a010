"""seamless-m4t-medium — enc-dec 12L+12L d1024 16H d_ff 4096 vocab 256206;
audio frontend is a stub (frame embeddings) [arXiv:2308.11596]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    num_layers=24, enc_layers=12, dec_layers=12,
    d_model=1024, num_heads=16, num_kv_heads=16,
    head_dim=64, d_ff=4096, vocab_size=256_206,
    activation="gelu", num_patch_tokens=0, frontend_dim=160,
)
