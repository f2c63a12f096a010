"""A model configuration file (``bench/configs/<name>.json``) read into
the sizes the yardstick works with.

The file keeps the source's own key names (Hugging Face ``config.json``
for Granite, ``MambaConfig`` for Mamba-2), so each value can be checked
against its source.  Its ``model_type`` names the family module that
reads it, ``bench/families/<model_type>.py`` (:func:`family`), whose
``read`` maps the keys onto one :class:`Model`: the only description of
a model that the counts, the weights and the plain reference read.
Nothing here imports the program.
"""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, Optional

FAMILIES = Path(__file__).resolve().parent / "families"


@dataclass(frozen=True)
class SSM:
    state: int          # N, the SSD state per head
    head_dim: int       # P
    expand: int
    conv: int           # W, the causal conv's width
    chunk: int          # the SSD chunk the program scans in
    d_inner: int
    heads: int

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.state


@dataclass(frozen=True)
class Model:
    """A model as the shared counts read it.  ``family`` is the
    configuration's ``model_type`` (its module under ``families/``);
    ``param_count`` and ``matmul_param_count`` are the family's counts
    of every parameter and of those a token multiplies through in the
    layers; ``attn_layers`` and ``ssm_layers`` are the layers that run
    attention and the SSD recurrence, which the kernel counts charge."""
    name: str
    family: str
    layers: int
    d_model: int
    vocab: int
    norm_eps: float
    param_count: int
    matmul_param_count: int
    attn_layers: int = 0
    ssm_layers: int = 0
    heads: int = 0
    kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    rope_theta: float = 10000.0
    ssm: Optional[SSM] = None
    engine: Dict = field(default_factory=dict, compare=False, hash=False)
    raw: Dict = field(default_factory=dict, compare=False, hash=False)

    def kv_bytes_per_token(self) -> int:
        """Bytes of one token's K and V over every attention layer, in
        bf16."""
        return 2 * self.attn_layers * self.kv_heads * self.head_dim * 2

    def state_bytes_per_row(self) -> int:
        """Bytes of one sequence's recurrent state over every SSM layer:
        the conv window in bf16 and the SSD state in float32."""
        if self.ssm is None:
            return 0
        s = self.ssm
        conv = (s.conv - 1) * s.conv_channels * 2
        ssd = s.heads * s.head_dim * s.state * 4
        return self.ssm_layers * (conv + ssd)


@dataclass(frozen=True)
class Ranks:
    """Where a family's hooks run: this process's ``rank`` of ``world``
    (one a card), and a CPU ``gloo`` group over them (None alone)."""
    rank: int = 0
    world: int = 1
    group: Any = None


SOLO = Ranks()


def draws_shares(m: Model, ranks: Ranks) -> bool:
    """Whether each rank draws only its share of ``m``'s weights: where
    its family module sets ``SHARES = True`` and more than one rank
    serves.  Each rank then draws from its own stream, the token table
    is cut by rows over the ranks, and every rank computes the
    reference together (``reference.logits``); otherwise every rank
    draws the whole model from the seed and rank 0 alone judges."""
    return ranks.world > 1 and getattr(family(m.family), "SHARES", False)


def family(name: str) -> ModuleType:
    """The module ``bench.families.<name>``."""
    if not (FAMILIES / f"{name}.py").is_file():
        found = sorted(f.name for f in FAMILIES.glob("*.py")
                       if not f.name.startswith("_"))
        raise ValueError(f"model_type {name!r}: no bench/families/{name}.py; "
                         f"the benchmark has {found}")
    return importlib.import_module(f"bench.families.{name}")


def from_dict(c: Dict) -> Model:
    return family(c["model_type"]).read(c["name"], c)


def load(path: Path) -> Model:
    return from_dict(json.loads(Path(path).read_text()))
