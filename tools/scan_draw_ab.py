#!/usr/bin/env python3
"""Times the PyTorch/CUDA port's zero scan and token-choice draw of one
source tree on the card, at the shapes of ``chip_smoke.py``'s phase 2.

    python3 tools/scan_draw_ab.py TREE LABEL

TREE is the root of a checkout: its ``src/repro_torch`` is imported and
its kernels are built into ``TREE/build/repro_torch``.  Each run prints
the card's name and power limit, then one line ``{"tree": LABEL, ...}``
with:

* ``cache_scan_ms``: the median host ms of ``PagedKVCache.
  scan_zero_pages`` over 16 pages of granite-3-8b's full-size (K, V)
  pair (40 layers, 1024 pages of 16 x 8 x 128 bf16): 8 pages zero, one
  of them holding a ``-0.0`` in K's last layer and one a 1 in V only,
  8 random; the call returns host flags, so it includes its wait;
* ``scan_ms``: the mean ms of ``pim_page_zero_scan`` on the K arena
  alone (CUDA events over back-to-back calls; no wait);
* ``draw_ms``: the mean ms of the token choice's draw at (8, 1) with
  the K-block's pad-row fold (rows 6 and 7 onto row 0), as the tree's
  ``_select_tokens`` makes it; ``draw_4096x256_ms`` the uniforms at
  (4096, 256);
* ``choice_ms`` and ``choice_kernels``: the mean ms of one sampled
  ``_select_tokens`` call on (8, 49155) logits with that fold, and the
  device kernels the profiler counts in one call;
* the launches counted under ``page_zero_scan`` by one cache scan;
* ``*_device_us``: from ``torch.profiler`` over 20 calls, the card's
  time per call in the scan kernels (``cache_scan``, ``scan``) or the
  generator kernels (``draw``), and in every device event of the call
  (``*_all_device_us``: kernels, copies and fills).

To compare two commits on one card, unpack the parent with
``git archive`` into a git-ignored directory and run parent, change,
change, parent in one call; each run is its own process, so the two
trees' packages never meet.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time

import numpy as np
import torch


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Median host ms of ``fn``, which waits for the card itself."""
    for _ in range(warmup):
        fn()
    ms = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


def device_us(fn, pattern: str, n: int = 20) -> tuple:
    """Device µs per call of ``fn`` in the kernels whose name contains
    ``pattern``, and in all its device events, from the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]

    def total(e):
        return getattr(e, "device_time_total", None) or e.cuda_time_total

    return (sum(total(e) for e in events if pattern in e.key) / n,
            sum(total(e) for e in events) / n)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree")
    ap.add_argument("label")
    args = ap.parse_args()
    sys.path.insert(0, f"{args.tree}/src")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.kernels.ambit import ops as amb_ops
    from repro_torch.kernels.drange import ops as dr_ops
    from repro_torch.serving import engine as E
    from repro_torch.serving.kv_cache import PagedKVCache

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    cfg = ARCHS["granite-3-8b"]
    cache = PagedKVCache(cfg, num_pages=1024, page_size=16, device=dev,
                         zero_scan=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    pages = list(range(600, 616))
    for a in (cache.k_arena, cache.v_arena):
        a[:, pages[8:]] = torch.randn(a[:, pages[8:]].shape, generator=gen,
                                      device=dev, dtype=a.dtype)
    cache.k_arena[-1, pages[3]].view(-1)[-1] = -0.0
    cache.v_arena[0, pages[5]].view(-1)[0] = 1.0
    flags = cache.scan_zero_pages(pages)
    want = [i < 8 and i not in (3, 5) for i in range(16)]
    if list(flags) != want:
        raise AssertionError(f"scan flags {list(flags)} != {want}")
    reset_launches()
    cache.scan_zero_pages(pages)
    scan_launches = launch_counts()["page_zero_scan"]

    seed = (0x9E3779B9, 12345)
    rowmap = torch.tensor([0, 1, 2, 3, 4, 5, 0, 0], device=dev)
    fused = "rowmap" in inspect.signature(
        dr_ops.pim_random_uniform).parameters
    if fused:
        def draw():
            return dr_ops.pim_random_uniform(seed, 8, 1, dev, rowmap=rowmap)
    else:
        def draw():
            return dr_ops.pim_random_uniform(seed, 8, 1, dev)[:, 0][rowmap]
    logits = torch.randn((8, cfg.vocab_size), generator=gen, device=dev,
                         dtype=torch.bfloat16)
    temps = np.asarray([1.0, 0.0, 0.7, 1.0, 0.0, 1.0, 1.0, 1.0], np.float32)

    def choice():
        return E._select_tokens(logits, temps, seed, rowmap=rowmap)

    choice()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        choice()
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not e.key.startswith("Memcpy"))
    out = {
        "tree": args.label, "card": card, "draw_fused": fused,
        "cache_scan_ms": host_ms(lambda: cache.scan_zero_pages(pages)),
        "cache_scan_launches": scan_launches,
        "scan_ms": time_ms(lambda: amb_ops.pim_page_zero_scan(
            cache.k_arena, pages)),
        "draw_ms": time_ms(draw),
        "draw_4096x256_ms": time_ms(lambda: dr_ops.pim_random_uniform(
            seed, 4096, 256, dev)),
        "choice_ms": time_ms(choice),
        "choice_kernels": kernels,
    }
    for name, fn, pattern in (
            ("cache_scan", lambda: cache.scan_zero_pages(pages),
             "zero_scan"),
            ("scan", lambda: amb_ops.pim_page_zero_scan(cache.k_arena,
                                                        pages), "zero_scan"),
            ("draw", draw, "drange")):
        out[f"{name}_device_us"], out[f"{name}_all_device_us"] = \
            device_us(fn, pattern)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
