"""The plain reference: the configurations' forward passes in plain
PyTorch and float32, written from the published descriptions, with no
kernel, cache or batching of the program's.  It imports nothing of the
program and takes only the benchmark's weights (``bench.weights``) and
token ids.  What every family shares is here (the token table, the
final norm, the logits, the control's rounding and the judging); each
family's layers are in its module under ``bench/families/``.

``logits(m, w, seqs, precision=...)`` runs each sequence whole (prompt
and served tokens, teacher-forced) and returns the logits at the
positions that chose each served token.  ``precision="fp8"`` is the
control: every matrix product's operands (weights, activations, and
attention's Q, K and V) rounded to float8 e4m3 with a per-tensor scale
first, the step a lower-precision serving path would take.

``widest_gap`` judges greedy tokens; ``draw_stats`` judges tokens drawn
at temperature 1 by how they fall in the reference's distributions, and
``draw`` makes such tokens (the control's, and the planted faults').

A family module states its departures from the published model, the
same in the program.

Where each rank holds only its share of the weights
(``model.draws_shares``), every rank runs :func:`logits` together: the
token table's rows and the output table are cut over the ranks, so a
lookup is summed over them and the logits gathered; a family's layer
sums its partial outputs by :func:`all_sum`.  These collectives use the
default process group, the engine's (``nccl`` on the cards).  The
control's float8 scales are then each share's own.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from bench.model import SOLO, Model, Ranks, family

FP8_MAX = 448.0
HEADS_AT_ONCE = 8


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (its largest
    magnitude at the format's largest finite value), back in float32."""
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


@contextlib.contextmanager
def full_float32():
    """Float32 products at full precision (no TF32) while inside."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, in place."""
    torch.distributed.all_reduce(x)
    return x


def all_cat(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x``, in rank order, along the last dimension."""
    parts = [torch.empty_like(x) for _ in range(
        torch.distributed.get_world_size())]
    torch.distributed.all_gather(parts, x.contiguous())
    return torch.cat(parts, dim=-1)


def embed(m: Model, table: torch.Tensor, tokens: torch.Tensor,
          ranks: Ranks) -> torch.Tensor:
    """The rows of ``tokens`` in the token table, in float32: the whole
    table, or this rank's block of rows, each rank adding the rows it
    holds (a sum with zeros, exact)."""
    if table.shape[0] == m.vocab:
        return table[tokens].float()
    n = table.shape[0]
    local = tokens - ranks.rank * n
    held = (local >= 0) & (local < n)
    x = table[local.clamp(0, n - 1)].float() * held[:, None]
    return all_sum(x)


class _Lin:
    """Matrix products ``x @ W`` in float32, operands rounded first by
    ``q`` (identity, or the control's float8).  A layer's weights are
    converted once (:meth:`layer`) and used for every sequence."""

    def __init__(self, q: Callable):
        self.q = q

    def layer(self, w: Dict[str, torch.Tensor], l: int,
              names: Sequence[str]) -> Dict[str, torch.Tensor]:
        return {n: self.q(w[n][l].float()) for n in names}

    def __call__(self, x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
        return self.q(x) @ wt


def logits(m: Model, w: Dict[str, torch.Tensor],
           seqs: Sequence[Tuple[Sequence[int], int]],
           precision: str = "float32",
           ranks: Ranks = SOLO) -> List[torch.Tensor]:
    """For each ``(tokens, first)``: the float32 logits (n, vocab) at
    positions ``first .. len(tokens) - 1``, each the distribution over
    the token after it.  ``precision``: "float32" (the reference) or
    "fp8" (the control).  The layers are the family's
    (``families/<model_type>.py``: ``layer(m, w, lw, l, x, lin, ranks)``
    over the weights it names in ``LAYER_WEIGHTS``); the output table is
    ``head`` where the family draws one, else the token table.  With
    the weights cut over the ranks, every rank calls this and gets the
    whole logits."""
    lin = _Lin({"float32": _same, "fp8": _fp8}[precision])
    fam = family(m.family)
    dev = w["embed"].device
    with torch.no_grad(), full_float32():
        xs = [embed(m, w["embed"], torch.as_tensor(list(t), dtype=torch.long,
                                                   device=dev), ranks)
              for t, _ in seqs]
        for l in range(m.layers):
            lw = lin.layer(w, l, fam.LAYER_WEIGHTS)
            xs = [fam.layer(m, w, lw, l, x, lin, ranks) for x in xs]
            del lw
        table = lin.q(w.get("head", w["embed"]).float()).t()
        out = [lin(rms(x[first:], w["final_norm"], m.norm_eps), table)
               for x, (_, first) in zip(xs, seqs)]
        if table.shape[1] == m.vocab:
            return out
        return [all_cat(o) for o in out]


def widest_gap(ref: torch.Tensor, chosen: torch.Tensor) -> float:
    """How far below the reference's best logit the chosen tokens' logits
    lie, at the worst position: ``max_t (max_v ref[t, v] - ref[t,
    chosen[t]])``."""
    best = ref.max(dim=-1).values
    got = ref.gather(1, chosen.view(-1, 1).long().to(ref.device))[:, 0]
    return float((best - got).max())


def draw(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The inverse-CDF draw from ``softmax(logits)`` (token-id order) at
    the uniforms ``u``, one a row."""
    cum = torch.cumsum(torch.softmax(logits.double(), dim=-1), dim=-1)
    u = u.to(cum.device, torch.float64)[:, None]
    return (cum <= u).sum(-1).clamp(max=logits.shape[-1] - 1)


def draw_stats(refs: Sequence[torch.Tensor], chosen: Sequence[torch.Tensor],
               gen: torch.Generator) -> Dict[str, float]:
    """Two tests that tokens were drawn from the reference's
    distributions (``refs``: logits rows, temperature 1), each row given
    the tokens before it:

    * ``nll_z``: the sum over rows of ``-log p(token)`` less the row's
      entropy, over the square root of the summed variances of ``-log
      p``: a z-score, about N(0, 1) for a sound draw (each term has mean
      0 given the rows before it); an argmax choice reads far below 0, a
      draw from another row or a flat draw far above;
    * ``pit_ks``: the randomised probability integral transform of each
      token, ``F(token - 1) + v p(token)`` with ``v`` uniform from
      ``gen``, is uniform on [0, 1) for a sound draw; its Kolmogorov-
      Smirnov distance from uniform, times the square root of the
      number of rows (about 1.36 at the 5% level, 1.95 at 0.1%), sees a
      biased or stuck uniform under the inverse-CDF draw."""
    dz = var = 0.0
    pits = []
    for r, c in zip(refs, chosen):
        lp = torch.log_softmax(r.double(), dim=-1)
        p = lp.exp()
        c = c.view(-1, 1).long().to(r.device)
        pc = p.gather(1, c)[:, 0]
        ent = -(p * lp).sum(-1)
        dz += float((-lp.gather(1, c)[:, 0] - ent).sum())
        var += float(((p * lp.square()).sum(-1) - ent.square()).sum())
        below = torch.cumsum(p, dim=-1).gather(1, c)[:, 0] - pc
        v = torch.rand(len(pc), generator=gen, dtype=torch.float64)
        pits.append((below + v.to(r.device) * pc).clamp(0.0, 1.0).cpu())
    u = torch.cat(pits).sort().values
    n = len(u)
    i = torch.arange(1, n + 1, dtype=torch.float64) / n
    ks = float(torch.maximum(i - u, u - (i - 1.0 / n)).max())
    return {"nll_z": dz / math.sqrt(max(var, 1e-30)),
            "pit_ks": ks * math.sqrt(n), "tokens": n}
