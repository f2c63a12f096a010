"""A model configuration file (``bench/configs/<name>.json``) read into
the sizes the yardstick works with.

The file keeps the source's own key names (Hugging Face ``config.json``
for Granite, ``MambaConfig`` for Mamba-2), so each value can be checked
against its source; :func:`load` maps them onto one :class:`Model`, the
only description of a model that the counts, the weights and the plain
reference read.  Nothing here imports the program.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional


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
    name: str
    family: str         # "dense" (GQA attention + SwiGLU) or "ssm"
    layers: int
    d_model: int
    vocab: int
    norm_eps: float
    heads: int = 0
    kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    rope_theta: float = 10000.0
    ssm: Optional[SSM] = None
    engine: Dict = field(default_factory=dict, compare=False, hash=False)
    raw: Dict = field(default_factory=dict, compare=False, hash=False)

    # ------------------------- parameter counts ------------------------ #

    def layer_params(self) -> int:
        """Parameters of one layer, its norms included."""
        d = self.d_model
        if self.family == "dense":
            attn = d * self.head_dim * (2 * self.heads + 2 * self.kv_heads)
            return attn + 3 * d * self.d_ff + 2 * d
        s = self.ssm
        in_proj = d * (2 * s.d_inner + 2 * s.state + s.heads)
        conv = (s.conv + 1) * s.conv_channels
        return (in_proj + conv + 3 * s.heads + s.d_inner
                + s.d_inner * d + d)

    def params(self) -> int:
        """Every parameter: the tied table once, the layers, the final
        norm."""
        return (self.vocab * self.d_model + self.layers * self.layer_params()
                + self.d_model)

    def matmul_params(self) -> int:
        """Parameters a token multiplies through in the layers (the
        projections; norms, conv taps and per-head scalars excluded)."""
        d = self.d_model
        if self.family == "dense":
            attn = d * self.head_dim * (2 * self.heads + 2 * self.kv_heads)
            return self.layers * (attn + 3 * d * self.d_ff)
        s = self.ssm
        return self.layers * (d * (2 * s.d_inner + 2 * s.state + s.heads)
                              + s.d_inner * d)

    def kv_bytes_per_token(self) -> int:
        """Bytes of one token's K and V over every layer, in bf16."""
        if self.family != "dense":
            return 0
        return 2 * self.layers * self.kv_heads * self.head_dim * 2

    def state_bytes_per_row(self) -> int:
        """Bytes of one sequence's recurrent state over every layer: the
        conv window in bf16 and the SSD state in float32."""
        if self.ssm is None:
            return 0
        s = self.ssm
        conv = (s.conv - 1) * s.conv_channels * 2
        ssd = s.heads * s.head_dim * s.state * 4
        return self.layers * (conv + ssd)


def _dense(name: str, c: Dict) -> Model:
    d = c["hidden_size"]
    heads = c["num_attention_heads"]
    return Model(
        name=name, family="dense", layers=c["num_hidden_layers"], d_model=d,
        vocab=c["vocab_size"], norm_eps=c["rms_norm_eps"], heads=heads,
        kv_heads=c["num_key_value_heads"],
        head_dim=c.get("head_dim", d // heads), d_ff=c["intermediate_size"],
        rope_theta=c["rope_theta"], engine=c["engine"], raw=c)


def _ssm(name: str, c: Dict) -> Model:
    d = c["d_model"]
    s = c["ssm_cfg"]
    d_in = s["expand"] * d
    ssm = SSM(state=s["d_state"], head_dim=s["headdim"], expand=s["expand"],
              conv=s["d_conv"], chunk=s["chunk_size"], d_inner=d_in,
              heads=d_in // s["headdim"])
    # the tied table's rows: the vocabulary padded as the checkpoint pads it
    pad = c.get("pad_vocab_size_multiple", 1)
    vocab = -(-c["vocab_size"] // pad) * pad
    return Model(name=name, family="ssm", layers=c["n_layer"], d_model=d,
                 vocab=vocab, norm_eps=c["norm_epsilon"], ssm=ssm,
                 engine=c["engine"], raw=c)


_FAMILIES = {"granite": _dense, "mamba2": _ssm}


def from_dict(c: Dict) -> Model:
    try:
        build = _FAMILIES[c["model_type"]]
    except KeyError:
        raise ValueError(f"model_type {c.get('model_type')!r}: the "
                         f"benchmark reads {sorted(_FAMILIES)}") from None
    return build(c["name"], c)


def load(path: Path) -> Model:
    return from_dict(json.loads(Path(path).read_text()))
