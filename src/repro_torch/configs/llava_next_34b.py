"""llava-next-34b — VLM: 60L d7168 56H (GQA kv=8) d_ff 20480 backbone;
anyres patch frontend is a stub (patch embeddings) [hf:llava-hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    head_dim=128, d_ff=20480, vocab_size=64_000,
    activation="swiglu", rope_theta=5_000_000.0,
    num_patch_tokens=256, frontend_dim=1024,
)
