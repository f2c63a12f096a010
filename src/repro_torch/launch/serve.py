"""Serving entry point: batched requests through the port's paged
engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \\
      --requests 8 --prompt-len 24 --max-new 16 [--share-prefix] \\
      [--device cpu]

The port's counterpart of the JAX package's ``launch/serve.py``, with
the same flags plus ``--device`` (default: the CUDA card).  With
``--share-prefix`` the engine runs the radix prefix cache: request 0's
prompt is served and committed first, then the rest are submitted with
no sharing arguments, and the second half (request 0's prompt with a
fresh 4-token tail) attach its full pages automatically (a family
with Mamba layers declines the hits).  The command line serves the
reduced model of ``--arch`` (dense, ssm, hybrid or moe, e.g.
``mamba2-1.3b`` or ``jamba-1.5-large-398b``) with weights drawn from a
seeded generator, its prompts prefilled whole and its requests
sampled at the default temperature of 1.0, as the JAX script's are;
:func:`serve` is the reusable body, which
callers give any config, parameters and engine settings
(``chip_smoke.py`` gives it granite-3-8b at full width).  The open-loop
entry point with the async front door is
``repro_torch.launch.serve_async``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.models import transformer as T
from repro_torch.models.params import init_params
from repro_torch.serving.engine import PagedEngine, Request


def serve(cfg: ModelConfig, params, requests: List[Request], *,
          page_size: int = 16, num_pages: int = 256,
          device: DeviceLike = None,
          between_rounds: Optional[Callable[[PagedEngine, int], None]] = None,
          setup: Optional[Callable[[PagedEngine], None]] = None,
          **engine_kw) -> Dict:
    """Serve ``requests`` to completion, one engine step at a time.

    ``engine_kw`` go to :class:`PagedEngine` (chunking, mixed rounds,
    K-block decode, the prefix cache, ``seed``).  ``setup(engine)`` runs
    once before the first request is submitted (the smoke test turns on
    the zero scan there).  A step is one engine round, or, when nothing
    waits for admission, up to ``decode_block_rounds`` rounds so that a
    K-block engine runs its blocks.  ``between_rounds(engine,
    step_index)`` runs after each step (the smoke test forks, frees and
    submits there).  Returns the finished token lists, the engine,
    host-clock seconds per step (each step ends in its device-to-host
    token transfer and a device synchronise, so the seconds include the
    device's work) and each step's ``launches_by_kind`` delta."""
    dev = resolve_device(device)
    engine = PagedEngine(cfg, params, page_size=page_size,
                         num_pages=num_pages, device=dev, **engine_kw)
    if setup is not None:
        setup(engine)
    for r in requests:
        engine.submit(r)
    results: Dict[int, List[int]] = {}
    round_seconds: List[float] = []
    round_launches: List[Dict[str, int]] = []
    queue = engine.cache.queue
    t0 = time.perf_counter()
    while engine.has_work:
        rounds = (engine.decode_block_rounds
                  if engine.prefill_backlog_tokens() == 0 else 1)
        before = queue.snapshot()
        t = time.perf_counter()
        results.update(engine.run(max_rounds=rounds))
        synchronize(dev)
        round_seconds.append(time.perf_counter() - t)
        round_launches.append(queue.delta(before))
        if between_rounds is not None:
            between_rounds(engine, len(round_seconds) - 1)
    seconds = time.perf_counter() - t0
    return {"results": results, "engine": engine, "seconds": seconds,
            "round_seconds": round_seconds, "round_launches": round_launches,
            "tokens": sum(len(v) for v in results.values())}


def make_requests(cfg: ModelConfig, n: int, prompt_len: int, max_new: int,
                  share: Optional[str], page_size: int,
                  rng: np.random.Generator) -> List[Request]:
    """The JAX serve script's workload: request 0's prompt is the base;
    with ``share`` ("pairwise" or "prefix") the second half reuse it (a
    fresh 4-token tail), pairwise naming request 0 and its page-aligned
    prefix, or leaving the match to the radix prefix cache."""
    base = rng.integers(0, cfg.vocab_size, prompt_len).astype(np.int32)
    reqs = []
    for i in range(n):
        if share and i >= n // 2:
            p = base.copy()
            p[-4:] = rng.integers(0, cfg.vocab_size, 4)
            kw = dict(share_with=0, shared_len=(prompt_len - 4) // page_size
                      * page_size) if share == "pairwise" else {}
            reqs.append(Request(i, p, max_new_tokens=max_new, **kw))
        else:
            p = base if i == 0 else rng.integers(
                0, cfg.vocab_size, prompt_len).astype(np.int32)
            reqs.append(Request(i, p, max_new_tokens=max_new))
    return reqs


def main(argv: Optional[List[str]] = None) -> Dict:
    """Serve the command line's scenario (``argv``: its arguments, the
    process's by default); prints and returns the summary."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--share-prefix", action="store_true",
                    help="second half of requests reuse the first prompt "
                         "(minus a fresh 4-token tail); the radix prefix "
                         "cache dedupes the shared pages automatically")
    ap.add_argument("--share-pairwise", action="store_true",
                    help="second half of requests share request 0's "
                         "page-aligned prompt prefix (share_with/shared_len)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced(ARCHS[args.arch])
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(T.model_defs(cfg), gen, dev)
    share = ("prefix" if args.share_prefix
             else "pairwise" if args.share_pairwise else None)
    reqs = make_requests(cfg, args.requests, args.prompt_len, args.max_new,
                         share, args.page_size, np.random.default_rng(0))
    later = reqs[1:] if args.share_prefix else []

    def commit_base_first(engine, step):
        # radix path: request 0 runs to the end (its prompt committed to
        # the tree) before the sharers arrive
        if later and not engine.has_work:
            for r in later:
                engine.submit(r)
            later.clear()

    out = serve(cfg, params, reqs[:1] if args.share_prefix else reqs,
                page_size=args.page_size, device=dev,
                prefix_cache=args.share_prefix,
                between_rounds=commit_base_first)
    engine = out["engine"]
    summary = {
        "device": str(dev), "requests": len(out["results"]),
        "tokens": out["tokens"], "seconds": out["seconds"],
        "engine_stats": engine.stats,
        "cache_stats": engine.cache.stats,
        "launches_by_kind": engine.cache.queue.launches_by_kind,
        "ops_saved_by_sharing": engine.cache.queue.saved_by_kind,
        "pages_in_use_at_end": engine.cache.pages_in_use,
    }
    print(json.dumps(summary, indent=1))
    for rid in sorted(out["results"])[:4]:
        print(rid, out["results"][rid][:10])
    return dict(summary, results=out["results"])


if __name__ == "__main__":
    main()
