"""Architecture registry: --arch <id> -> ModelConfig."""
from __future__ import annotations

from typing import Dict

from .base import ModelConfig
from .gemma_2b import CONFIG as gemma_2b
from .minitron_8b import CONFIG as minitron_8b
from .granite_3_8b import CONFIG as granite_3_8b
from .stablelm_3b import CONFIG as stablelm_3b
from .jamba_1_5_large_398b import CONFIG as jamba_1_5_large_398b
from .seamless_m4t_medium import CONFIG as seamless_m4t_medium
from .llava_next_34b import CONFIG as llava_next_34b
from .llama4_scout_17b_a16e import CONFIG as llama4_scout_17b_a16e
from .deepseek_v2_236b import CONFIG as deepseek_v2_236b
from .mamba2_1_3b import CONFIG as mamba2_1_3b

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in [
        gemma_2b, minitron_8b, granite_3_8b, stablelm_3b,
        jamba_1_5_large_398b, seamless_m4t_medium, llava_next_34b,
        llama4_scout_17b_a16e, deepseek_v2_236b, mamba2_1_3b,
    ]
}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
