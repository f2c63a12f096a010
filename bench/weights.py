"""Random bf16 weights made from ``--seed``, on the device, in a few
large calls.

The benchmark owns the weights: it draws them here, hands the same
tensors to the program (``system.program_params`` lays them out as the
program's tree, views and no copies) and to the plain reference, which
reads them by name.  Every normal leaf is a slice of one ``torch.randn``
over the whole model, scaled in place; the rest are a few fills.

Every family has ``embed (V, d)`` (the token table, drawn first; also
the output table unless the family draws an untied ``head (V, d)``) and
``final_norm (d,)`` (ones).  Its module under ``families/`` names the
rest: ``leaves(m, ranks)``, the normal leaves after the table as
``(name, shape, std)`` in draw order, and ``fill(m, w, gen, ranks)``,
the other leaves, drawn from ``gen`` after the normal draw.

A family that sets ``SHARES = True`` draws, on each of several ranks,
only that rank's share (``model.draws_shares``): its hooks return this
rank's blocks, as the program's tensor-parallel layout cuts them, and
the token table here is this rank's block of ``V / world`` rows.  Each
rank then draws from its own stream of the seed.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from bench.model import SOLO, Model, Ranks, draws_shares, family

EMBED_STD = 0.02
# elements a draw: a few large calls for a whole model
DRAW = 1 << 30


def ones(dev, *shape) -> torch.Tensor:
    return torch.ones(shape, dtype=torch.bfloat16, device=dev)


def make(m: Model, seed: int, device,
         ranks: Ranks = SOLO) -> Dict[str, torch.Tensor]:
    """Every weight of ``m`` in bfloat16 on ``device``, drawn from
    ``seed`` by a generator on that device."""
    fam = family(m.family)
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    rows = m.vocab
    if draws_shares(m, ranks):
        if m.vocab % ranks.world:
            raise ValueError(f"{m.name}: a vocabulary of {m.vocab} does not "
                             f"cut into {ranks.world} shares")
        rows = m.vocab // ranks.world
        gen.manual_seed((seed % (1 << 58)) * 32 + ranks.rank)
    else:
        gen.manual_seed(seed % (1 << 63))
    leaves = ([("embed", (rows, m.d_model), EMBED_STD)]
              + fam.leaves(m, ranks))
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    flat = torch.empty(total, dtype=torch.bfloat16, device=dev)
    for at in range(0, total, DRAW):
        flat[at:at + DRAW].normal_(generator=gen)
    w: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, std in leaves:
        n = math.prod(shape)
        w[name] = flat[at:at + n].view(shape).mul_(std)
        at += n
    w["final_norm"] = ones(dev, m.d_model)
    fam.fill(m, w, gen, ranks)
    return w
