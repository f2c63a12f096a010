from .base import (ModelConfig, MoEConfig, MLAConfig, SSMConfig, ShapeConfig,
                   ParallelConfig, OptimizerConfig, RunConfig, SHAPES,
                   cells_for, reduced)
from .registry import ARCHS, get
