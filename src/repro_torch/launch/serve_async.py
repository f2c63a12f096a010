"""Open-system serving entry point: Poisson arrivals against the async
front door, measured as goodput under an SLO.

  PYTHONPATH=src python -m repro_torch.launch.serve_async \\
      --arch granite-3-8b --rates 2,8,32 --requests 24 --ttft-slo-ms 500 \\
      [--device cpu]

The port's counterpart of the JAX package's ``launch/serve_async.py``,
with the same flags plus ``--device`` (default: the CUDA card).
Closed-loop runs understate tail latency: the next request arrives
only when the last one finished, so the system is never overloaded.
This entry point is open-loop — arrivals follow a Poisson process at a
fixed rate whatever the server is doing — and reports how much work
completed within its SLO (goodput), how much was shed at admission, the
latency percentiles, what the radix prefix cache saved, and
``replay_speedup``: the run's recorded arena schedule replayed on the
simulated DDR3 prototype (RowClone/Ambit against memcpy/calloc, the
prototype's speedups, not the card's).
"""

from __future__ import annotations

import argparse
import asyncio
import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.server import AsyncServer, TokenStream


def _percentile(xs: List[float], q: float) -> Optional[float]:
    return float(np.percentile(xs, q)) if xs else None


async def poisson_open_loop(server: AsyncServer, prompts: Sequence,
                            rate_rps: float, *, max_new_tokens: int = 16,
                            temperature: float = 0.0,
                            deadline_ms: Optional[float] = None,
                            seed: int = 0) -> Dict[str, object]:
    """Drive ``server`` with one open-loop Poisson trace.

    One request per entry of ``prompts``, inter-arrival gaps drawn
    i.i.d. exponential at ``rate_rps``; every stream is consumed
    concurrently (tokens are awaited as they arrive, like a real
    client).  Returns the trace's SLO accounting:

    * ``goodput_rps`` / ``goodput_tok_s`` — requests (and their tokens)
      that were admitted, completed, and met their deadline, per second
      of trace wall time;
    * ``rejected`` — shed at admission (infeasible deadline);
    * ``ttft_*_ms`` / ``itl_*_ms`` — latency percentiles over completed
      requests;
    * per-request detail in ``streams`` (the :class:`TokenStream`
      objects, timing marks included).
    """
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=len(prompts))
    streams: List[TokenStream] = []
    consumers: List[asyncio.Task] = []
    t0 = asyncio.get_running_loop().time()
    for prompt, gap in zip(prompts, gaps):
        await asyncio.sleep(float(gap))
        s = await server.submit(prompt, max_new_tokens=max_new_tokens,
                                temperature=temperature,
                                deadline_ms=deadline_ms)
        streams.append(s)
        consumers.append(asyncio.ensure_future(s.drain()))
    await asyncio.gather(*consumers)
    wall_s = asyncio.get_running_loop().time() - t0

    good = [s for s in streams
            if not s.rejected and s.finished_ms is not None
            and (deadline_ms is None or s.e2e_ms <= deadline_ms)]
    ttfts = [s.ttft_ms for s in streams if s.ttft_ms is not None]
    itls = [g for s in streams for g in s.itl_ms()]
    return {
        "rate_rps": rate_rps,
        "requests": len(streams),
        "rejected": sum(s.rejected for s in streams),
        "completed": sum(s.finished_ms is not None and not s.rejected
                         for s in streams),
        "good": len(good),
        "goodput_rps": len(good) / wall_s,
        "goodput_tok_s": sum(len(s.tokens) for s in good) / wall_s,
        "wall_s": wall_s,
        "ttft_p50_ms": _percentile(ttfts, 50),
        "ttft_p99_ms": _percentile(ttfts, 99),
        "itl_p50_ms": _percentile(itls, 50),
        "itl_p99_ms": _percentile(itls, 99),
        "streams": streams,
    }


def shared_prefix_prompts(n: int, vocab: int, *, prefix_len: int,
                          tail_len: int, seed: int = 0) -> List[np.ndarray]:
    """A multi-tenant trace: every prompt opens with the same
    ``prefix_len``-token system prompt, followed by a per-request
    ``tail_len``-token suffix — the workload where the radix prefix
    cache turns (n-1) prefills into page attaches."""
    rng = np.random.default_rng(seed)
    sys_prompt = rng.integers(0, vocab, prefix_len).astype(np.int32)
    return [np.concatenate([sys_prompt,
                            rng.integers(0, vocab, tail_len)
                            .astype(np.int32)])
            for _ in range(n)]


async def _amain(args) -> None:
    import torch

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import PagedEngine, Request
    from repro_torch.serving.trace import replay_on_device

    dev = resolve_device(args.device)
    cfg = reduced(ARCHS[args.arch])
    params = init_params(T.model_defs(cfg),
                         torch.Generator(device=dev).manual_seed(0), dev)
    rates = [float(r) for r in args.rates.split(",")]
    out = []
    for rate in rates:
        engine = PagedEngine(cfg, params, page_size=args.page_size,
                             num_pages=args.num_pages, device=dev,
                             max_prefill_chunk=args.chunk,
                             prefix_cache=True, record_trace=True)
        # warm up outside the timed trace
        engine.submit(Request(10**6, np.arange(args.prefix_len + args.tail_len)
                              % cfg.vocab_size, max_new_tokens=2))
        engine.run()
        prompts = shared_prefix_prompts(
            args.requests, cfg.vocab_size,
            prefix_len=args.prefix_len, tail_len=args.tail_len)
        server = AsyncServer(engine, ttft_slo_ms=args.ttft_slo_ms,
                             itl_p99_target_ms=args.itl_target_ms)
        async with server:
            res = await poisson_open_loop(
                server, prompts, rate, max_new_tokens=args.max_new,
                deadline_ms=args.deadline_ms)
        res.pop("streams")
        res["device"] = str(dev)
        res["prefix"] = {k: engine.stats[k] for k in
                         ("prefix_hits", "prefix_hit_tokens",
                          "prefix_evictions")}
        res["ops_saved"] = dict(engine.cache.queue.saved_by_kind)
        rep = replay_on_device(engine.cache.trace)
        res["replay_speedup"] = rep["speedup"]
        out.append(res)
        print(json.dumps(res, indent=1))
    print(json.dumps({"sweep": [
        {k: r[k] for k in ("rate_rps", "goodput_rps", "rejected",
                           "ttft_p99_ms")} for r in out]}, indent=1))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--rates", default="2,8,32",
                    help="comma-separated Poisson arrival rates (req/s)")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--prefix-len", type=int, default=32,
                    help="shared system-prompt length (tokens)")
    ap.add_argument("--tail-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=64,
                    help="initial max_prefill_chunk (auto-tuned)")
    ap.add_argument("--ttft-slo-ms", type=float, default=1000.0)
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--itl-target-ms", type=float, default=None,
                    help="decode-p99 target for the chunk auto-tuner")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    asyncio.run(_amain(ap.parse_args()))


if __name__ == "__main__":
    main()
