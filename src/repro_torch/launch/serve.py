"""Serving entry point: batched requests through the port's paged
engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \\
      --requests 8 --prompt-len 24 --max-new 16 [--device cpu]

The port's counterpart of the JAX package's ``launch/serve.py``, with
the same flags plus ``--device`` (default: the CUDA card).  The command
line serves the reduced model of ``--arch`` with weights drawn from a
seeded generator, its requests sampled at the default temperature of
1.0 as the JAX script's are; :func:`serve` is the reusable body, which
callers give any config, parameters and engine settings
(``chip_smoke.py`` gives it granite-3-8b at full width).
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
          **engine_kw) -> Dict:
    """Serve ``requests`` to completion, one engine step at a time.

    ``engine_kw`` go to :class:`PagedEngine` (chunking, mixed rounds,
    K-block decode, ``seed``).  A step is one engine round, or, when
    nothing waits for admission, up to ``decode_block_rounds`` rounds so
    that a K-block engine runs its blocks.  ``between_rounds(engine,
    step_index)`` runs after each step (the smoke test forks, frees and
    submits there).  Returns the finished token lists, the engine,
    host-clock seconds per step (each step ends in its device-to-host
    token transfer and a device synchronise, so the seconds include the
    device's work) and each step's ``launches_by_kind`` delta."""
    dev = resolve_device(device)
    engine = PagedEngine(cfg, params, page_size=page_size,
                         num_pages=num_pages, device=dev, **engine_kw)
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
                  share_pairwise: bool, page_size: int,
                  rng: np.random.Generator) -> List[Request]:
    """The JAX serve script's workload: request 0's prompt is the base; with
    ``share_pairwise`` the second half reuse it (a fresh 4-token tail)
    and share its page-aligned prefix."""
    base = rng.integers(0, cfg.vocab_size, prompt_len).astype(np.int32)
    reqs = []
    for i in range(n):
        if share_pairwise and i >= n // 2:
            p = base.copy()
            p[-4:] = rng.integers(0, cfg.vocab_size, 4)
            reqs.append(Request(i, p, max_new_tokens=max_new, share_with=0,
                                shared_len=(prompt_len - 4) // page_size
                                * page_size))
        else:
            p = base if i == 0 else rng.integers(
                0, cfg.vocab_size, prompt_len).astype(np.int32)
            reqs.append(Request(i, p, max_new_tokens=max_new))
    return reqs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--share-prefix", action="store_true",
                    help="radix prefix cache (not ported yet: raises)")
    ap.add_argument("--share-pairwise", action="store_true",
                    help="second half of requests share request 0's "
                         "page-aligned prompt prefix (share_with/shared_len)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    if args.share_prefix:
        raise NotImplementedError(
            "--share-prefix needs the radix prefix cache, a later slice")

    dev = resolve_device(args.device)
    cfg = reduced(ARCHS[args.arch])
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(T.model_defs(cfg), gen, dev)
    reqs = make_requests(cfg, args.requests, args.prompt_len, args.max_new,
                         args.share_pairwise, args.page_size,
                         np.random.default_rng(0))
    out = serve(cfg, params, reqs, page_size=args.page_size, device=dev)
    engine = out["engine"]
    print(json.dumps({
        "device": str(dev), "requests": len(out["results"]),
        "tokens": out["tokens"], "seconds": out["seconds"],
        "engine_stats": engine.stats,
        "cache_stats": engine.cache.stats,
        "launches_by_kind": engine.cache.queue.launches_by_kind,
        "ops_saved_by_sharing": engine.cache.queue.saved_by_kind,
        "pages_in_use_at_end": engine.cache.pages_in_use,
    }, indent=1))
    for rid in sorted(out["results"])[:4]:
        print(rid, out["results"][rid][:10])


if __name__ == "__main__":
    main()
