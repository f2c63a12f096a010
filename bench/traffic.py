"""The one traffic generator: a mix file (``bench/traffic/<name>.json``)
and a seed in, requests out.

Every seed gets the same multiset of sizes (and, in an open loop, of
arrival gaps), in another order: lengths are drawn at a fixed grid of
quantiles (``pool`` points) of the mix's distributions, paired by a
fixed permutation, and the seed only orders the pairs, picks the token
ids and picks which requests are greedy.  The order is stratified
(:func:`stratified`): every run of ``BLOCK`` consecutive requests holds
one request of each of ``BLOCK`` prompt-length strata (spread over the
output lengths too), and every run of ``BLOCK`` arrivals one gap of
each gap stratum, so that a window sees the same work and the same
offered rate whatever the seed.

A mix file holds:

* ``loop``: ``"closed"`` (``clients`` requests in flight, each client
  sending its next one when its last finishes) or ``"open"`` (Poisson
  arrivals at ``rate_rps``, timed from when each request is due);
* ``prompt`` / ``output``: ``{"median", "sigma", "min", "max"}`` of a
  lognormal, clipped; ``max_total`` caps prompt + output;
* ``prefix``: optional ``{"tokens", "tenants", "zipf_s", "shared"}``:
  every prompt opens with ``tokens`` leading tokens, its tenant's
  system prompt when ``shared`` (tenants drawn Zipf with exponent
  ``zipf_s``), or tokens of its own when not; ``prompt`` then sizes the
  tail after them;
* ``temperature`` and ``greedy_every``: every ``greedy_every``-th
  request (by a seeded phase) is greedy, so that the served tokens of
  those can be judged against the reference;
* ``warmup_seconds``: how long the loop runs before the window opens.

The engine's settings are the deployment's, in the configuration file,
never the mix's.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from statistics import NormalDist
from typing import Dict, Iterator, List, Optional

import numpy as np

POOL = 1024
BLOCK = 32


@dataclass
class Spec:
    """One request as the generator makes it."""
    index: int
    prompt: np.ndarray          # int32 token ids
    max_new: int
    temperature: float
    tenant: int = -1            # -1: no shared prefix
    shared: int = 0             # leading tokens another request may share
    gap_s: float = 0.0          # open loop: seconds after the previous one


def load(path: Path) -> Dict:
    return json.loads(Path(path).read_text())


def lognormal_grid(d: Dict, n: int) -> np.ndarray:
    """``n`` lengths at the quantiles (i + 1/2) / n of a lognormal of
    median ``d["median"]`` and shape ``d["sigma"]``, clipped to
    ``[d["min"], d["max"]]``."""
    nd = NormalDist()
    q = [(i + 0.5) / n for i in range(n)]
    x = np.array([d["median"] * math.exp(d["sigma"] * nd.inv_cdf(p))
                  for p in q])
    return np.clip(np.rint(x), d["min"], d["max"]).astype(np.int64)


def zipf_grid(n_tenants: int, s: float, n: int) -> np.ndarray:
    """``n`` tenant ids at the grid quantiles of a Zipf law over
    ``n_tenants`` (tenant 0 the most popular)."""
    w = np.array([1.0 / (k + 1) ** s for k in range(n_tenants)])
    cdf = np.cumsum(w / w.sum())
    q = (np.arange(n) + 0.5) / n
    return np.minimum(np.searchsorted(cdf, q), n_tenants - 1)


def exp_grid(rate: float, n: int) -> np.ndarray:
    """``n`` gaps (s) at the grid quantiles of an exponential."""
    q = (np.arange(n) + 0.5) / n
    return -np.log1p(-q) / rate


def stratified(rng: np.random.Generator, key: np.ndarray,
               second: Optional[np.ndarray] = None,
               block: int = BLOCK) -> np.ndarray:
    """An order of ``range(len(key))`` in which each run of ``block``
    consecutive entries takes one entry from each of ``block`` strata of
    ``key`` (equal-count slices of its sorted order).  Within a stratum
    the entries are ranked by ``second`` (when given) and dealt out to
    the blocks from a random offset, so the blocks also spread over
    ``second``; the seed picks the offsets and each block's order."""
    n = len(key)
    if n % block:
        raise ValueError(f"a pool of {n} does not split into {block} strata")
    strata = np.argsort(key, kind="stable").reshape(block, n // block)
    cols = []
    for s in strata:
        if second is not None:
            s = s[np.argsort(second[s], kind="stable")]
        else:
            s = s[rng.permutation(len(s))]
        cols.append(np.roll(s, int(rng.integers(0, len(s)))))
    blocks = np.stack(cols, axis=1)               # (n / block, block)
    for row in blocks:
        rng.shuffle(row)
    return blocks.reshape(-1)


def size_pool(mix: Dict, pool: int = POOL) -> np.ndarray:
    """The mix's (tail length, output length, tenant) pairs, the same
    for every seed: rows of an int64 array, in a fixed order."""
    tail = lognormal_grid(mix["prompt"], pool)
    out = lognormal_grid(mix["output"], pool)
    fixed = np.random.default_rng(0)
    out = out[fixed.permutation(pool)]
    pre = mix.get("prefix", {}).get("tokens", 0)
    cap = mix.get("max_total")
    if cap is not None:
        out = np.minimum(out, cap - pre - tail)
    if min(out) < 1:
        raise ValueError("max_total leaves a request no output token")
    tenants = np.full(pool, -1)
    if "prefix" in mix:
        p = mix["prefix"]
        tenants = zipf_grid(p["tenants"], p["zipf_s"], pool)[
            fixed.permutation(pool)]
    return np.stack([tail, out, tenants], axis=1)


def requests(mix: Dict, seed: int, vocab: int,
             pool: int = POOL) -> Iterator[Spec]:
    """An endless stream of requests: passes over the size pool, each
    in an order drawn from ``seed``."""
    rng = np.random.default_rng([seed, 1])
    sizes = size_pool(mix, pool)
    gaps = (exp_grid(mix["rate_rps"], pool) if mix["loop"] == "open"
            else np.zeros(pool))
    pre = mix.get("prefix")
    systems: List[np.ndarray] = []
    if pre is not None and pre.get("shared", True):
        systems = [rng.integers(0, vocab, pre["tokens"], dtype=np.int32)
                   for _ in range(pre["tenants"])]
    every = mix.get("greedy_every", 0)
    phase = int(rng.integers(0, every)) if every else 0
    index = 0
    while True:
        order = stratified(rng, sizes[:, 0], sizes[:, 1])
        gap_order = stratified(rng, gaps)
        for k, g in zip(order, gap_order):
            tail, out, tenant = (int(v) for v in sizes[k])
            parts = []
            shared = 0
            if pre is not None:
                if systems:
                    parts.append(systems[tenant])
                    shared = pre["tokens"]
                else:
                    parts.append(rng.integers(0, vocab, pre["tokens"],
                                              dtype=np.int32))
            parts.append(rng.integers(0, vocab, tail, dtype=np.int32))
            greedy = bool(every) and index % every == phase
            yield Spec(index=index, prompt=np.concatenate(parts),
                       max_new=out,
                       temperature=0.0 if greedy else mix["temperature"],
                       tenant=tenant if systems else -1, shared=shared,
                       gap_s=float(gaps[g]))
            index += 1


def override(mix: Dict, **kw) -> Dict:
    """A copy of ``mix`` with top-level keys replaced (the knee sweep
    sets its rate with it)."""
    out = json.loads(json.dumps(mix))
    out.update(kw)
    return out
