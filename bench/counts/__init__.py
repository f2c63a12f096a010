"""The work a step needs, counted from its logical shapes: the batch,
the context lengths and the model's widths, never from the kernels
that do it.  A later change that fuses, splits or renames kernels
leaves these counts as they are.

Each function returns ``(flops, bytes)``; :func:`least_seconds` turns a
pair into the least time an H100 needs for it (the larger of the two
bounds) and says which bound it is.  Conventions:

* a multiply-add is 2 operations; bf16 weights and K/V are 2 bytes, the
  SSD state 4;
* a step reads every weight once (the tied table once, for the logits);
  a decode row reads its K/V (or its state) once and writes its new
  token's K/V (or writes its state back);
* attention over ``c`` keys costs ``4 * c * heads * head_dim`` a query
  a layer (scores and the weighted sum);
* the SSD recurrence costs ``5 * heads * head_dim * state`` a token a
  layer (decay, input outer product, update, read-out), the conv ``2 *
  W * channels``.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

from bench.model import Model

# One NVIDIA H100 SXM, data sheet: dense bf16 tensor-core rate and HBM3
# bandwidth, at the full 700 W power limit.
PEAK_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

Work = Tuple[float, float]


def least_seconds(work: Work, chips: int = 1) -> Tuple[float, str]:
    """The least time for ``(flops, bytes)`` on ``chips`` H100s that
    share it evenly, and which bound sets it ("flops" or "bytes")."""
    flops, nbytes = work
    t_ops = flops / (PEAK_FLOPS * chips)
    t_mem = nbytes / (PEAK_BYTES_PER_S * chips)
    return (t_ops, "flops") if t_ops >= t_mem else (t_mem, "bytes")


def add(*works: Work) -> Work:
    return (sum(w[0] for w in works), sum(w[1] for w in works))


def weight_bytes(m: Model) -> float:
    """Bytes of every weight in bf16: what one step reads."""
    return 2.0 * m.param_count


def logits_flops(m: Model, rows: int) -> float:
    return 2.0 * rows * m.vocab * m.d_model


def _attn_flops(m: Model, keys: float) -> float:
    """Attention of queries whose key counts sum to ``keys``, over every
    attention layer."""
    return 4.0 * keys * m.heads * m.head_dim * m.attn_layers


def _ssm_token_flops(m: Model) -> float:
    """One token's SSD recurrence and conv over every SSM layer."""
    s = m.ssm
    if s is None:
        return 0.0
    return m.ssm_layers * (5.0 * s.heads * s.head_dim * s.state
                           + 2.0 * s.conv * s.conv_channels)


def token_flops(m: Model, context: float) -> float:
    """One token through the layers (projections, attention over
    ``context`` keys, the SSM recurrence); the logits excluded."""
    return (2.0 * m.matmul_param_count + _attn_flops(m, context)
            + _ssm_token_flops(m))


def decode_rows(m: Model, contexts: Sequence[int]) -> Work:
    """The per-row work of one decode round: each row's token through
    the layers and the logits, its K/V read and written and its state
    read and written back.  The weights are :func:`step_weights`'."""
    n = len(contexts)
    keys = float(sum(contexts))
    flops = (2.0 * m.matmul_param_count * n + logits_flops(m, n)
             + _attn_flops(m, keys) + _ssm_token_flops(m) * n)
    nbytes = (m.kv_bytes_per_token() * (keys + n)
              + 2.0 * m.state_bytes_per_row() * n)
    return flops, nbytes


def chunk(m: Model, q: int, prefix: int) -> Work:
    """A prefill chunk of ``q`` prompt tokens after ``prefix`` committed
    ones: the tokens through the layers, causal attention over the
    prefix and the chunk (the prefix's K/V read, the chunk's written),
    and the state read and written once.  The logits of a finishing
    prompt are counted with the token it emits."""
    keys = q * prefix + q * (q + 1) / 2.0
    flops = (2.0 * m.matmul_param_count * q + _attn_flops(m, keys)
             + _ssm_token_flops(m) * q)
    nbytes = (m.kv_bytes_per_token() * (prefix + q)
              + 2.0 * m.state_bytes_per_row())
    return flops, nbytes


def step_weights(m: Model, steps: int) -> Work:
    return 0.0, weight_bytes(m) * steps


def call(m: Model, steps: int, contexts: Sequence[int],
         chunks: Iterable[Tuple[int, int]], first_tokens: int) -> Work:
    """The work of one engine call: ``steps`` device steps (each reading
    the weights), decode rows at ``contexts``, prefill ``chunks`` as
    ``(q, prefix)`` and ``first_tokens`` logits rows of prompts that
    finished."""
    return add(step_weights(m, steps), decode_rows(m, contexts),
               *(chunk(m, q, p) for q, p in chunks),
               (logits_flops(m, first_tokens), 0.0))


# ----------------------------- kernels -------------------------------- #


def paged_attention(m: Model, contexts: Sequence[int]) -> Work:
    """One decode round's paged attention over every layer: each row's
    query against its ``context`` keys (K and V read once, the query
    read and the output written in bf16)."""
    keys = float(sum(contexts))
    n = len(contexts)
    flops = _attn_flops(m, keys)
    nbytes = m.attn_layers * (keys * m.kv_heads * m.head_dim * 2 * 2
                         + n * m.heads * m.head_dim * 2 * 2)
    return flops, nbytes


def flash_prefix(m: Model, q: int, prefix: int) -> Work:
    """One chunk row's flash attention over every layer: ``q`` queries,
    causal over themselves and the ``prefix`` committed keys (Q read,
    K/V of the prefix and the chunk read, O written, in bf16)."""
    keys = q * prefix + q * (q + 1) / 2.0
    flops = _attn_flops(m, keys)
    nbytes = m.attn_layers * (2 * q * m.heads * m.head_dim * 2
                         + (prefix + q) * m.kv_heads * m.head_dim * 2 * 2)
    return flops, nbytes


def state_scatter(m: Model, rows: int) -> Work:
    """Writing ``rows`` sequences' new state (conv window and SSD state
    over every layer) into the arena: each byte read once and written
    once."""
    return 0.0, 2.0 * rows * m.state_bytes_per_row()


def ssd_step(m: Model, rows: int) -> Work:
    """The decode step's SSD state update for ``rows`` rows over every
    SSM layer: each row's float32 state read once from the arena and
    its new state written once, its x, B and C read in bf16 and dt in
    float32, and its y written in float32; the update's operations are
    the recurrence's share of :func:`_ssm_token_flops` (the conv is
    not the kernel's)."""
    s = m.ssm
    if s is None:
        return 0.0, 0.0
    hp = s.heads * s.head_dim
    per_layer = (2 * hp * s.state * 4 + hp * 2 + s.heads * 4
                 + 2 * s.state * 2 + hp * 4)
    flops = rows * m.ssm_layers * 5.0 * hp * s.state
    return flops, float(rows * m.ssm_layers * per_layer)
