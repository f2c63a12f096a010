#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card (sm_90a).

    python3 chip_smoke.py          # from the repository root

Phases, each printing one JSON line; any failure raises and the script
exits nonzero:

1. card and build: the card's name and power limit, torch's version,
   and the build of every kernel in ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, started together);
2. kernel parity: each kernel against its plain PyTorch version on the
   card, at the shapes the serving path gives it, with its time, the
   plain version's, the least time the card could take (``bound_ms``)
   and one PyTorch call computing the same function where there is one
   (``library_ms``, a yardstick the port never calls);
3. serving: granite-3-8b at full width and depth (40 layers, random
   bf16 weights from a seeded generator) answers 8 greedy requests
   through ``repro_torch.launch.serve.serve``, with a CoW fork of a live
   sequence and its free between rounds; the kernel launch counts are
   zeroed just before and read just after, and every kernel of the path
   must have launched;
4. cross-check: the same engine at full width and 2 layers on the card
   and on the CPU (plain versions) from identical weights.

The last lines are the card's ``nvidia-smi`` name and power limit, the
kernels' JSON summary, and ``{"ok": true, "device": {...}}``.  Without a
CUDA card, or without the rest of the repository beside it, the script
exits nonzero before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
BF16_FLOPS = 989e12             # dense bf16 tensor-core peak, same source
ATTN_TOL = 2e-2                 # bf16 outputs: spacing 2**-8 relative
# phase 4: logits are rounded to bf16 before the fp32 cast (as in the JAX
# package); at |logit| in [4, 8) bf16 spacing is 2**-5, and this allows
# about three such steps between the card's and the CPU's rounding
LOGIT_ATOL = 0.1
MARGIN = 2 * LOGIT_ATOL


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    from CUDA events."""
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


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(a.view(torch.int16), b.view(torch.int16)))


# ---------------------------------------------------------------------- #
# Phase 2: kernel parity at the serving path's shapes
# ---------------------------------------------------------------------- #


def parity(dev) -> dict:
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import ref as pa_ref
    from repro_torch.kernels.rowclone import ops as rc_ops
    from repro_torch.kernels.rowclone import ref as rc_ref
    import torch.nn.functional as F

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=bf16)

    # -- kv_scatter: L=40, P=1024, S=16, E=8*128, B=8 with pad duplicates
    L, P, S, KVH, D, B = 40, 1024, 16, 8, 128, 8
    E = KVH * D
    arena = randn(L, P, S, KVH, D)
    new = randn(L, B, KVH, D)
    pages_l = [3, 17, 200, 511, 800, 1000, 3, 17]
    slots_l = [0, 5, 15, 7, 1, 9, 0, 5]
    new[:, 6] = new[:, 0]                # pad rows: same slot, same payload
    new[:, 7] = new[:, 1]
    pages = torch.tensor(pages_l, dtype=torch.int32, device=dev)
    slots = torch.tensor(slots_l, dtype=torch.int32, device=dev)
    want = rc_ref.kv_scatter(arena.clone().view(L, P, S, E), pages, slots,
                             new.view(L, B, E))
    got = rc_ops.kv_scatter_inline(arena.clone(), pages, slots, new)
    torch.cuda.synchronize()
    if not same_bits(got.view(L, P, S, E), want):
        raise AssertionError("kv_scatter disagrees with its plain version")
    work = arena.clone()
    flat = work.view(L, P * S, E)
    flat_idx = (pages.long() * S + slots.long())
    nb, by = bound(2 * L * len(set(zip(pages_l, slots_l))) * E * 2
                   + 2 * B * 4, 0)
    rows["kv_scatter"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: rc_ops.kv_scatter_inline(work, pages, slots,
                                                    new)),
        plain_ms=time_ms(lambda: rc_ref.kv_scatter(
            work.view(L, P, S, E), pages, slots, new.view(L, B, E))),
        bound_ms=nb, bound_by=by,
        library_ms=time_ms(lambda: flat.index_copy_(1, flat_idx,
                                                    new.view(L, B, E))))
    del want, got

    # -- page copy / init: 16 ops, one op's dst is another op's src
    src = list(range(100, 116))
    dst = list(range(200, 215)) + [100]   # op 15 writes what op 0 reads
    want = rc_ref.page_copy_batched(arena.clone(), torch.tensor(src),
                                    torch.tensor(dst))
    got = rc_ops.pim_page_copy_batched(arena.clone(), src, dst)
    torch.cuda.synchronize()
    if not same_bits(got, want):
        raise AssertionError("page_copy_batched disagrees with its plain "
                             "version")
    page_bytes = S * E * 2
    nb, by = bound(len(src) * L * page_bytes * 2, 0)
    rows["page_copy_batched"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: rc_ops.pim_page_copy_batched(work, src, dst)),
        plain_ms=time_ms(lambda: rc_ref.page_copy_batched(
            work, torch.tensor(src, device=dev),
            torch.tensor(dst, device=dev))),
        bound_ms=nb, bound_by=by, library_ms=None)
    init_pages = dst
    want = rc_ref.page_init_batched(arena.clone(),
                                    torch.tensor(init_pages), 0.0)
    got = rc_ops.pim_page_init_batched(arena.clone(), init_pages, 0.0)
    torch.cuda.synchronize()
    if not same_bits(got, want):
        raise AssertionError("page_init_batched disagrees with its plain "
                             "version")
    init_idx = torch.tensor(init_pages, device=dev)
    nb, by = bound(len(init_pages) * L * page_bytes, 0)
    rows["page_init_batched"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: rc_ops.pim_page_init_batched(work, init_pages,
                                                        0.0)),
        plain_ms=time_ms(lambda: rc_ref.page_init_batched(work, init_idx,
                                                          0.0)),
        bound_ms=nb, bound_by=by,
        library_ms=time_ms(lambda: work.index_fill_(1, init_idx, 0.0)))
    del want, got, work, flat, arena

    # -- paged attention: B=8, H=32, KVH=8, D=128, lengths 1..1040, k_self
    H = 32
    k_ar, v_ar = randn(P, S, KVH, D), randn(P, S, KVH, D)
    lens_l = [1, 1040, 517, 64, 233, 800, 15, 999]
    need = [-(-n // S) for n in lens_l]
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(1))
    width = 1 << (max(need) - 1).bit_length()
    bt = torch.zeros((B, width), dtype=torch.int32)
    at = 0
    for b, n in enumerate(need):
        bt[b, :n] = perm[at:at + n]
        at += n
    bt = bt.to(dev)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    q = randn(B, H, D)
    k_self, v_self = randn(B, KVH, D), randn(B, KVH, D)
    args = (q, k_ar, v_ar, bt, lens)
    kw = dict(k_self=k_self, v_self=v_self)
    got = pa_ops.paged_attention(*args, return_lse=True, **kw)
    want = pa_ref.paged_attention(*args, return_lse=True, **kw)
    torch.cuda.synchronize()
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=ATTN_TOL,
                                   rtol=ATTN_TOL)
    tot = sum(lens_l)
    nbytes = (2 * tot * KVH * D * 2 + 2 * B * H * D * 2
              + 2 * B * KVH * D * 2 + B * width * 4 + B * 4)
    flops = 4 * H * D * (tot + B)
    nb, by = bound(nbytes, flops)
    # yardstick: SDPA over K/V gathered and head-expanded beforehand
    maxlen = width * S
    kg = torch.cat([k_ar[bt.long()].view(B, maxlen, KVH, D),
                    k_self[:, None]], 1)
    vg = torch.cat([v_ar[bt.long()].view(B, maxlen, KVH, D),
                    v_self[:, None]], 1)
    kg = kg.transpose(1, 2).repeat_interleave(H // KVH, 1).contiguous()
    vg = vg.transpose(1, 2).repeat_interleave(H // KVH, 1).contiguous()
    pos = torch.arange(maxlen + 1, device=dev)
    mask = ((pos[None] < lens[:, None]) | (pos[None] == maxlen))
    mask = mask[:, None, None, :]
    q4 = q[:, :, None]
    rows["paged_attention"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: pa_ops.paged_attention(*args, **kw)),
        plain_ms=time_ms(lambda: pa_ref.paged_attention(*args, **kw)),
        bound_ms=nb, bound_by=by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q4, kg, vg, attn_mask=mask)))
    del kg, vg, k_ar, v_ar

    # -- flash attention: B=4, H=32, KVH=8, S=512, D=128, ragged lengths
    Bf, Sf = 4, 512
    fl = [512, 1, 300, 77]
    qf, kf, vf = randn(Bf, H, Sf, D), randn(Bf, KVH, Sf, D), \
        randn(Bf, KVH, Sf, D)
    flens = torch.tensor(fl, dtype=torch.int32, device=dev)
    got = fa_ops.attention(qf, kf, vf, causal=True, lengths=flens)
    want = fa_ref.attention(qf, kf, vf, causal=True, lengths=flens)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=ATTN_TOL,
                               rtol=ATTN_TOL)
    pairs = sum(min(r + 1, n) for n in fl for r in range(Sf))
    nb, by = bound((2 * Bf * H * Sf * D + 2 * Bf * KVH * Sf * D) * 2,
                   4 * H * D * pairs)
    kx = kf.repeat_interleave(H // KVH, 1)
    vx = vf.repeat_interleave(H // KVH, 1)
    col = torch.arange(Sf, device=dev)
    fmask = (col[None, :] <= col[:, None])[None] \
        & (col[None, None, :] < flens[:, None, None])
    fmask = fmask[:, None]
    rows["flash_attention"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: fa_ops.attention(qf, kf, vf, causal=True,
                                            lengths=flens), iters=10),
        plain_ms=time_ms(lambda: fa_ref.attention(qf, kf, vf, causal=True,
                                                  lengths=flens), iters=10),
        bound_ms=nb, bound_by=by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qf, kx, vx, attn_mask=fmask), iters=10))
    return rows


# ---------------------------------------------------------------------- #
# Phase 3: full-width serving
# ---------------------------------------------------------------------- #


def granite_requests(cfg, Request):
    """8 greedy requests, prompt lengths from numpy seed 0 in [64, 1024];
    requests 6 and 7 share request 0's page-aligned prefix."""
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 1025, 8)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    reqs = []
    for i, p in enumerate(prompts):
        if i >= 6:
            shared = (min(len(prompts[0]), len(p)) // 2) // 16 * 16
            p = np.concatenate([prompts[0][:shared], p[shared:]])
            reqs.append(Request(i, p, max_new_tokens=32, share_with=0,
                                shared_len=shared))
        else:
            reqs.append(Request(i, p, max_new_tokens=32))
    return reqs


def serving(dev) -> dict:
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params, param_count
    from repro_torch.serving.engine import Request

    cfg = ARCHS["granite-3-8b"]
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(T.model_defs(cfg), gen, dev, torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = param_count(T.model_defs(cfg)) * 2
    reqs = granite_requests(cfg, Request)
    forked = {}

    def between_rounds(engine, i):
        # round 1: fork a live sequence whose tail page is partial (a
        # RowClone CoW copy); round 2: free the fork (RowClone-Init)
        if i == 1:
            for rid in sorted(engine.active):
                seq = engine.cache.seqs[rid]
                if seq.length % engine.cache.page_size:
                    engine.cache.fork(rid, 1000)
                    forked["from"] = rid
                    break
        elif i == 2 and forked:
            engine.cache.free(1000)

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    out = serve(cfg, params, reqs, page_size=16, num_pages=1024,
                device=dev, between_rounds=between_rounds)
    counts = launch_counts()
    engine = out["engine"]
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the path: {missing}")
    if not forked:
        raise AssertionError("no live sequence with a partial tail to fork")
    if engine.cache.pages_in_use != 0:
        raise AssertionError(f"{engine.cache.pages_in_use} pages leaked")
    results = out["results"]
    if sorted(results) != list(range(8)) or any(
            len(v) != 32 for v in results.values()):
        raise AssertionError("not every request got its 32 tokens")
    if not all(0 <= t < cfg.vocab_size for v in results.values()
               for t in v):
        raise AssertionError("token outside the vocabulary")
    rs = out["round_seconds"]
    st = engine.stats
    emit({"phase": "serve", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "params": param_count(T.model_defs(cfg)),
          "init_seconds": init_s,
          "prompt_lens": [int(len(r.prompt)) for r in reqs],
          "prefill_ms": st["prefill_seconds"] * 1e3,
          "first_round_ms": rs[0] * 1e3,
          "decode_round_ms": [x * 1e3 for x in rs[1:]],
          "decode_round_ms_median": float(np.median(rs[1:])) * 1e3,
          "tokens": out["tokens"], "seconds": out["seconds"],
          "tokens_per_s": out["tokens"] / out["seconds"],
          "weight_stream_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
          "launches_by_kind": _nonzero(engine.cache.queue.launches_by_kind),
          "kernel_launches": counts,
          "forked_from": forked["from"],
          "pages_in_use": engine.cache.pages_in_use,
          "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
          "streams_head": {k: v[:8] for k, v in sorted(results.items())}})
    del params, engine, out
    torch.cuda.empty_cache()
    return counts


def _nonzero(d):
    return {k: v for k, v in d.items() if v}


# ---------------------------------------------------------------------- #
# Phase 4: full width, 2 layers, card against CPU
# ---------------------------------------------------------------------- #


def cross_check(dev) -> dict:
    from repro_torch.configs import ARCHS, ParallelConfig
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params, tree_map
    from repro_torch.serving.engine import (PagedEngine, Request,
                                            _prefill_forward)

    cfg = dataclasses.replace(ARCHS["granite-3-8b"], num_layers=2)
    gen = torch.Generator(device=dev).manual_seed(1)
    p_gpu = init_params(T.model_defs(cfg), gen, dev, torch.bfloat16)
    p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (24, 17)]

    toks = np.zeros((2, 32), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lens = np.asarray([len(p) for p in prompts], np.int32)
    first = {}
    for name, params, d in (("gpu", p_gpu, dev), ("cpu", p_cpu, "cpu")):
        logits, _, _ = _prefill_forward(
            cfg, ParallelConfig(), params, torch.from_numpy(toks).to(d),
            torch.from_numpy(lens).to(d))
        first[name] = logits.float().cpu()
    first_err = float((first["gpu"] - first["cpu"]).abs().max())
    if first_err > LOGIT_ATOL:
        raise AssertionError(f"first-step logits differ by {first_err}")

    class Recording(PagedEngine):
        """Records its logits; with ``forced`` it takes every token from
        the reference run's choices (teacher forcing)."""

        def __init__(self, *a, forced=None, **k):
            super().__init__(*a, **k)
            self.forced = forced
            self.logits = []

        def _choose(self, rids, logits):
            self.logits.append(logits.float().cpu())
            if self.forced is None:
                return super()._choose(rids, logits)
            return self.forced[len(self.logits) - 1].argmax(-1).numpy()

    def run(params, d, forced=None):
        eng = Recording(cfg, params, page_size=16, num_pages=64, device=d,
                        forced=forced)
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, max_new_tokens=6))
        return eng, eng.run()

    ref_eng, ref_out = run(p_cpu, "cpu")
    gpu_eng, gpu_out = run(p_gpu, dev, forced=ref_eng.logits)
    checked = agree = 0
    step_err = 0.0
    for ours, ref in zip(gpu_eng.logits, ref_eng.logits):
        step_err = max(step_err, float((ours - ref).abs().max()))
        top2 = ref.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > MARGIN
        checked += int(sure.sum())
        agree += int((ours.argmax(-1) == ref.argmax(-1))[sure].sum())
    if agree != checked:
        raise AssertionError(f"greedy choices differ where the margin "
                             f"exceeds {MARGIN}: {agree}/{checked}")
    if gpu_out != ref_out:
        raise AssertionError("teacher-forced streams differ")
    if gpu_eng.cache.pages_in_use or ref_eng.cache.pages_in_use:
        raise AssertionError("pages leaked")
    return {"phase": "cross_check", "layers": 2, "d_model": cfg.d_model,
            "first_logits_max_abs_err": first_err,
            "logit_atol": LOGIT_ATOL,
            "decode_logits_max_abs_err": step_err,
            "choices_checked": checked,
            "choices_total": sum(len(x) for x in ref_eng.logits),
            "margin": MARGIN}


# ---------------------------------------------------------------------- #


KERNELS = {
    # name: (source in the repo, the TPU kernel it replaces)
    "kv_scatter": ("src/repro_torch/kernels/csrc/rowclone.cu",
                   "src/repro/kernels/rowclone/rowclone.py:215"),
    "page_copy_batched": ("src/repro_torch/kernels/csrc/rowclone.cu",
                          "src/repro/kernels/rowclone/rowclone.py:140"),
    "page_init_batched": ("src/repro_torch/kernels/csrc/rowclone.cu",
                          "src/repro/kernels/rowclone/rowclone.py:178"),
    "paged_attention": (
        "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention/paged_attention.py:124"),
    "flash_attention": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:118"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t0 = time.perf_counter()
    build_s = _build.build()
    for name in _build.SOURCES:
        _build.load(name)
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "build_seconds": build_s,
          "sources": list(_build.SOURCES)})

    rows = parity(dev)
    emit({"phase": "parity", **rows})
    counts = serving(dev)
    emit(cross_check(dev))

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    emit({"phase": "total", "seconds": time.perf_counter() - t0})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
