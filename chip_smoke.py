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
4. chunked serving: the same model and prompts under chunked prefill
   (256-token chunks), mixed rounds and 8-round decode blocks, requests
   4-7 arriving after the second step, even ids greedy and odd ids
   sampled at temperature 1.0, one with an EOS; its launch counts are
   zeroed and read around it, and mixed rounds, decode blocks, the
   generator and the prefix mode of flash attention must all have run;
5. trace: ``torch.profiler`` over one mixed round and one decode block
   of the same workload, the card's busy time by kernel group;
6. chunked against monolithic prefill: first-token logits of the two
   paths at full depth, printed as drawn and held within ``LOGIT_ATOL``
   with every ``wq`` scaled by 0.01 (see the function);
7. cross-check: the same engine at full width and 2 layers on the card
   and on the CPU (plain versions) from identical weights, then the
   card's sampled token choice against the CPU's on identical logits.

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
# float32 outside the tensor cores, same source: the table's rate for the
# CUDA cores, taken for the generator's 32-bit integer operations (the
# table has no int32 row; the card issues int32 at no more than this)
CUDA_CORE_OPS = 67e12
# Threefry2x32-20 per word: 20 x (add, 2 shifts + or, xor), 5 key
# injections of 3 adds, the initial 2 adds and the counter's xor
U32_OPS_PER_WORD = 20 * 5 + 5 * 3 + 2 + 1
ATTN_TOL = 2e-2                 # bf16 outputs: spacing 2**-8 relative
# phase 7: logits are rounded to bf16 before the fp32 cast (as in the JAX
# package); at |logit| in [4, 8) bf16 spacing is 2**-5, and this allows
# about three such steps between the card's and the CPU's rounding
LOGIT_ATOL = 0.1
MARGIN = 2 * LOGIT_ATOL
# phase 7's sampled choice: uniforms within this of a CDF boundary may
# fall on either side of it (float32 cumulative sums in another order)
BOUNDARY = 1e-5


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


def bound(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    """The least time (ms) for ``nbytes`` of memory traffic and
    ``flops`` operations at ``peak`` operations/s, and which bounds."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(a.view(torch.int16), b.view(torch.int16)))


# ---------------------------------------------------------------------- #
# Phase 2: kernel parity at the serving path's shapes
# ---------------------------------------------------------------------- #


def parity(dev) -> dict:
    from repro_torch.kernels.drange import ops as dr_ops
    from repro_torch.kernels.drange import ref as dr_ref
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
    del qf, kf, vf, kx, vx

    # -- flash attention, prefix-KV mode: B=4, H=32, KVH=8, D=128,
    # chunk 256, prefix capacity 1024 gathered through block tables
    # from a 1024-page arena, ragged committed lengths
    Sc, W = 256, 64
    cl = [256, 256, 100, 256]
    pl = [0, 16, 600, 1024]
    qc, kc, vc = randn(Bf, H, Sc, D), randn(Bf, KVH, Sc, D), \
        randn(Bf, KVH, Sc, D)
    k_ar, v_ar = randn(P, S, KVH, D), randn(P, S, KVH, D)
    btp = perm[:Bf * W].view(Bf, W).long().to(dev)
    kp = k_ar[btp].view(Bf, W * S, KVH, D).transpose(1, 2)
    vp = v_ar[btp].view(Bf, W * S, KVH, D).transpose(1, 2)
    clens = torch.tensor(cl, dtype=torch.int32, device=dev)
    plens = torch.tensor(pl, dtype=torch.int32, device=dev)
    pkw = dict(causal=True, lengths=clens, k_prefix=kp, v_prefix=vp,
               prefix_lengths=plens)
    got = fa_ops.attention(qc, kc, vc, **pkw)
    want = fa_ref.attention(qc, kc, vc, **pkw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=ATTN_TOL,
                               rtol=ATTN_TOL)
    # keys each query row sees: its committed prefix, and the chunk's
    # columns up to its own (within the chunk length)
    pairs = sum(p + min(r + 1, n) for p, n in zip(pl, cl)
                for r in range(Sc))
    nbytes = (2 * Bf * H * Sc * D + 2 * Bf * KVH * Sc * D
              + 2 * sum(pl) * KVH * D) * 2 + 2 * Bf * 4
    nb, by = bound(nbytes, 4 * H * D * pairs)
    # yardstick: SDPA with an explicit mask over [prefix ; chunk], K/V
    # concatenated and head-expanded beforehand
    kcat = torch.cat([kp, kc], 2).repeat_interleave(H // KVH, 1)
    vcat = torch.cat([vp, vc], 2).repeat_interleave(H // KVH, 1)
    col = torch.arange(W * S + Sc, device=dev)
    row = torch.arange(Sc, device=dev)[:, None]
    cc = col[None, None, :] - W * S
    pmask = torch.where(col[None, None, :] < W * S,
                        col[None, None, :] < plens[:, None, None],
                        (cc <= row[None]) & (cc < clens[:, None, None]))
    pmask = pmask[:, None]
    rows["flash_attention_prefix"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: fa_ops.attention(qc, kc, vc, **pkw), iters=10),
        plain_ms=time_ms(lambda: fa_ref.attention(qc, kc, vc, **pkw),
                         iters=10),
        bound_ms=nb, bound_by=by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qc, kcat, vcat, attn_mask=pmask), iters=10))
    del kcat, vcat, k_ar, v_ar, kp, vp

    # -- random_u32: bit for bit at the sampled path's (8, 1) and at
    # (4096, 256); the row's times are the serving shape's
    for shape in ((4096, 256), (8, 1)):
        seed = (0x9E3779B9, 12345)
        got = dr_ops.pim_random_u32(seed, *shape, device=dev)
        want = dr_ref.random_u32(seed, *shape, dev)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want):
            raise AssertionError(f"random_u32 {shape} disagrees with its "
                                 "plain version")
        n = shape[0] * shape[1]
        nb, by = bound(4 * n, U32_OPS_PER_WORD * n, CUDA_CORE_OPS)
        rows["random_u32" if shape == (8, 1) else "random_u32_4096x256"] = \
            dict(max_abs_err=0.0, shape=list(shape),
                 ms=time_ms(lambda: dr_ops.pim_random_u32(seed, *shape,
                                                          device=dev)),
                 plain_ms=time_ms(lambda: dr_ref.random_u32(seed, *shape,
                                                            dev)),
                 bound_ms=nb, bound_by=by, library_ms=None)
    return rows


# ---------------------------------------------------------------------- #
# Phases 3 and 4: full-width serving
# ---------------------------------------------------------------------- #


def granite_requests(cfg, Request, temperature=lambda i: 0.0):
    """8 requests, prompt lengths from numpy seed 0 in [64, 1024], request
    ``i`` at ``temperature(i)``; requests 6 and 7 share request 0's
    page-aligned prefix."""
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 1025, 8)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    reqs = []
    for i, p in enumerate(prompts):
        kw = dict(max_new_tokens=32, temperature=temperature(i))
        if i >= 6:
            shared = (min(len(prompts[0]), len(p)) // 2) // 16 * 16
            p = np.concatenate([prompts[0][:shared], p[shared:]])
            kw.update(share_with=0, shared_len=shared)
        reqs.append(Request(i, p, **kw))
    return reqs


def granite_params(dev):
    """granite-3-8b at full width and depth, random bf16 weights from a
    seeded generator on the card."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    cfg = ARCHS["granite-3-8b"]
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(T.model_defs(cfg), gen, dev, torch.bfloat16)
    torch.cuda.synchronize()
    return cfg, params, time.perf_counter() - t0


def check_streams(cfg, results, n, eos=None):
    """Every request finished with its 32 tokens (or stopped at its EOS)
    inside the vocabulary."""
    if sorted(results) != list(range(n)):
        raise AssertionError(f"finished requests {sorted(results)}")
    for rid, v in results.items():
        stop = eos.get(rid) if eos else None
        want = 32 if stop is None or stop not in v else v.index(stop) + 1
        if len(v) != want:
            raise AssertionError(f"request {rid}: {len(v)} tokens, "
                                 f"expected {want}")
        if not all(0 <= t < cfg.vocab_size for t in v):
            raise AssertionError(f"request {rid}: token outside the "
                                 "vocabulary")


def serving(dev, cfg, params, init_s) -> dict:
    """Phase 3: 8 greedy requests, monolithic prefill, one round a step,
    a CoW fork and its free between rounds."""
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.params import param_count
    from repro_torch.serving.engine import Request

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
    missing = [k for k in PHASE3_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the path: {missing}")
    if not forked:
        raise AssertionError("no live sequence with a partial tail to fork")
    if engine.cache.pages_in_use != 0:
        raise AssertionError(f"{engine.cache.pages_in_use} pages leaked")
    results = out["results"]
    check_streams(cfg, results, 8)
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
    return counts, results


def _round_kind(delta) -> str:
    """What a step ran, from its launches_by_kind delta."""
    if delta.get("fused_mixed"):
        return "mixed"
    if delta.get("fused_decode_block"):
        return "decode_block"
    if delta.get("fused_prefill"):
        return "chunk+decode" if delta.get("fused_decode") else "chunk"
    return "decode"


def serving_chunked(dev, cfg, params, greedy_streams) -> dict:
    """Phase 4: chunked prefill (256-token chunks), mixed rounds and
    8-round decode blocks; requests 0-3 first, 4-7 after step 2; even
    ids greedy, odd ids sampled at temperature 1.0; request 2 stops at
    an EOS taken from its phase-3 greedy stream."""
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.serve import serve
    from repro_torch.serving.engine import Request

    reqs = granite_requests(cfg, Request,
                            temperature=lambda i: float(i % 2))
    eos = {2: greedy_streams[2][8]}
    reqs[2].eos_token_id = eos[2]
    late = reqs[4:]

    def between_rounds(engine, i):
        if i == 1:
            for r in late:
                engine.submit(r)

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    out = serve(cfg, params, reqs[:4], page_size=16, num_pages=1024,
                device=dev, between_rounds=between_rounds,
                max_prefill_chunk=256, mixed_rounds=True,
                decode_block_rounds=8)
    counts = launch_counts()
    engine = out["engine"]
    missing = [k for k in CHUNKED_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the path: {missing}")
    by_kind = engine.cache.queue.launches_by_kind
    for kind in ("fused_mixed", "fused_decode_block", "fused_prefill"):
        if not by_kind.get(kind):
            raise AssertionError(f"no {kind} launch on the chunked path")
    if engine.cache.pages_in_use != 0:
        raise AssertionError(f"{engine.cache.pages_in_use} pages leaked")
    results = out["results"]
    check_streams(cfg, results, 8, eos)
    kinds = [_round_kind(d) for d in out["round_launches"]]
    ms = {}
    for k, sec in zip(kinds, out["round_seconds"]):
        ms.setdefault(k, []).append(sec * 1e3)
    agree = {rid: next((i for i, (a, b) in enumerate(
        zip(results[rid], greedy_streams[rid])) if a != b),
        min(len(results[rid]), 32)) for rid in (0, 2, 4, 6)}
    emit({"phase": "serve_chunked", "arch": cfg.name,
          "layers": cfg.num_layers, "max_prefill_chunk": 256,
          "decode_block_rounds": 8,
          "temperatures": [r.temperature for r in reqs],
          "eos": eos, "eos_fired": eos[2] in results[2],
          "tokens": out["tokens"], "seconds": out["seconds"],
          "tokens_per_s": out["tokens"] / out["seconds"],
          "steps": len(kinds),
          "step_kinds": {k: len(v) for k, v in ms.items()},
          "step_ms_median": {k: float(np.median(v)) for k, v in ms.items()},
          "step_ms": {k: v for k, v in ms.items()},
          "launches_by_kind": _nonzero(by_kind),
          "kernel_launches": counts,
          "stats": {k: engine.stats[k] for k in (
              "prefill_chunks", "mixed_dispatches", "multi_round_blocks",
              "decode_rounds", "fused_prefill_dispatches",
              "decode_stall_rounds")},
          "rng_ctr": engine.rng_ctr,
          "pages_in_use": engine.cache.pages_in_use,
          "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
          # greedy rows: tokens before the first difference from phase 3
          "greedy_prefix_agreement": agree,
          "streams_head": {k: v[:8] for k, v in sorted(results.items())}})
    return counts


def trace(dev, cfg, params) -> dict:
    """``torch.profiler`` over the phase-4 workload on a fresh engine:
    the card's busy time (the sum of its kernel and copy times; one
    stream, so they do not overlap) in the second mixed round and the
    second decode block (the first of each kind pays one-time costs),
    by kernel group, beside the step's host-clock time under the
    profiler (which slows the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import PagedEngine, Request

    engine = PagedEngine(cfg, params, page_size=16, num_pages=1024,
                         device=dev, max_prefill_chunk=256,
                         decode_block_rounds=8)
    reqs = granite_requests(cfg, Request, temperature=lambda i: float(i % 2))
    for r in reqs[:4]:
        engine.submit(r)
    queue = engine.cache.queue
    seen = {"mixed": 0, "decode_block": 0}
    out = {}
    steps = 0
    while engine.has_work and len(out) < 2:
        rounds = (engine.decode_block_rounds
                  if engine.prefill_backlog_tokens() == 0 else 1)
        before = queue.snapshot()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.run(max_rounds=rounds)
            torch.cuda.synchronize(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3
        steps += 1
        if steps == 2:
            for r in reqs[4:]:
                engine.submit(r)
        kind = _round_kind(queue.delta(before))
        if kind not in seen:
            continue
        seen[kind] += 1
        if seen[kind] != 2:
            continue
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        busy = {}
        for e in kernels:
            group = _kernel_group(e.key)
            busy[group] = busy.get(group, 0.0) \
                + e.self_device_time_total / 1e3
        total = sum(busy.values())
        out[kind] = {
            "profiled_step_ms": wall_ms,
            "device_busy_ms": total if total else "not measured",
            "busy_ms_by_group": dict(sorted(busy.items(),
                                            key=lambda kv: -kv[1])),
            "kernel_launches": sum(e.count for e in kernels)}
    if set(out) != set(seen):
        raise AssertionError(f"the traced run had only {sorted(out)}")
    return {"phase": "trace", "layers": cfg.num_layers, **out}


def _kernel_group(name: str) -> str:
    """A device event's group for the trace's breakdown."""
    n = name.lower()
    for key, group in (("flash_kernel", "flash_attention"),
                       ("paged", "paged_attention"),
                       ("drange", "random_u32"),
                       ("kv_scatter_kernel", "rowclone"),
                       ("rows_kernel", "rowclone"),
                       ("memcpy", "memcpy"), ("memset", "memset"),
                       ("gemm", "matmul"), ("gemv", "matmul"),
                       ("nvjet", "matmul"), ("cutlass", "matmul"),
                       ("xmma", "matmul")):
        if key in n:
            return group
    return "other (elementwise, norms, softmax, indexing)"


def chunked_vs_monolithic(dev, cfg, params) -> dict:
    """The chunked path's first-token logits against the monolithic
    prefill's, at full depth, for prompts 0, 2 and 4 (2-4 chunks of
    256): as drawn, and with every ``wq`` scaled by 0.01 (in place; the
    weights are not used afterwards).  As drawn, the attention scores
    have a standard deviation near 120, the softmax is nearly one-hot,
    and a bf16 rounding difference at a near-tie (the two paths sum in
    other orders) can change what a position attends to, so the two
    paths' logits part within a few layers; that difference is printed,
    not held.  Scaled, the scores are near 1.2 and the two paths must
    agree within LOGIT_ATOL."""
    from repro_torch.serving.engine import PagedEngine, Request

    class Last(PagedEngine):
        def _choose(self, logits, temps, seed, rowmap=None):
            self.logits = logits.float().cpu()
            return super()._choose(logits, temps, seed, rowmap)

    def first_logits(prompt, **kw):
        eng = Last(cfg, params, page_size=16, num_pages=256, device=dev,
                   **kw)
        eng.submit(Request(0, prompt, max_new_tokens=1, temperature=0.0))
        eng.run()
        return eng.logits[0]

    prompts = [r.prompt for r in granite_requests(cfg, Request)]
    out = {}
    for scale in (1.0, 0.01):
        if scale != 1.0:
            for key, group in params["group0"].items():
                if key.endswith("_attn"):
                    group["attn"]["wq"].mul_(scale)
        errs = {}
        for i in (0, 2, 4):
            mono = first_logits(prompts[i])
            chunked = first_logits(prompts[i], max_prefill_chunk=256)
            errs[i] = float((mono - chunked).abs().max())
        out[f"wq_x{scale:g}"] = errs
    if max(out["wq_x0.01"].values()) > LOGIT_ATOL:
        raise AssertionError(f"chunked and monolithic prefill logits "
                             f"differ by more than {LOGIT_ATOL}: {out}")
    return {"phase": "chunked_vs_monolithic", "layers": cfg.num_layers,
            "max_prefill_chunk": 256, "logit_atol": LOGIT_ATOL,
            "first_logits_max_abs_err": out}


def _nonzero(d):
    return {k: v for k, v in d.items() if v}


# ---------------------------------------------------------------------- #
# Phase 7: full width, 2 layers, card against CPU
# ---------------------------------------------------------------------- #


def cross_check(dev) -> dict:
    from repro_torch.configs import ARCHS, ParallelConfig
    from repro_torch.kernels.drange import ops as dr_ops
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params, tree_map
    from repro_torch.serving.engine import (PagedEngine, Request,
                                            _prefill_forward,
                                            _select_tokens)

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
            self.raw = []

        def _choose(self, logits, temps, seed, rowmap=None):
            self.raw.append(logits)
            self.logits.append(logits.float().cpu())
            if self.forced is None:
                return super()._choose(logits, temps, seed, rowmap)
            return self.forced[len(self.logits) - 1].argmax(-1).to(
                logits.device)

    def run(params, d, forced=None):
        eng = Recording(cfg, params, page_size=16, num_pages=64, device=d,
                        forced=forced)
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, max_new_tokens=6, temperature=0.0))
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
    sampled = sampled_choice(gpu_eng.raw, dev, _select_tokens, dr_ops)
    return {"phase": "cross_check", "layers": 2, "d_model": cfg.d_model,
            "first_logits_max_abs_err": first_err,
            "logit_atol": LOGIT_ATOL,
            "decode_logits_max_abs_err": step_err,
            "choices_checked": checked,
            "choices_total": sum(len(x) for x in ref_eng.logits),
            "margin": MARGIN, "sampled_choice": sampled}


def sampled_choice(card_logits, dev, select, dr_ops) -> dict:
    """The card's sampled token choice against the CPU's on identical
    logits (the card's own, copied to the CPU): the uniforms bit for
    bit, and the tokens wherever ``u`` lies farther from the CPU's
    nearest CDF boundary than BOUNDARY and than the two sides' CDFs
    differ on that row (float32 sums in another order over 49155
    entries)."""
    temps = np.asarray([1.0, 0.5, 0.25, 0.1], np.float32)
    checked = near = 0
    cum_err = 0.0
    for n, logits in enumerate(card_logits):
        for t in temps:
            tv = np.full((logits.shape[0],), t, np.float32)
            seed = (0x2545F491 + n, int(t * 1000))
            u_card = dr_ops.pim_random_uniform(seed, len(tv), 1, dev)
            u_cpu = dr_ops.pim_random_uniform(seed, len(tv), 1, "cpu")
            if not torch.equal(u_card.cpu(), u_cpu):
                raise AssertionError("card and CPU uniforms differ")
            got = select(logits, tv, seed).cpu()
            cpu_logits = logits.cpu()
            want = select(cpu_logits, tv, seed)
            c_card = torch.cumsum(torch.softmax(logits.float() / float(t),
                                                -1), -1).cpu()
            c_cpu = torch.cumsum(torch.softmax(cpu_logits.float() / float(t),
                                               -1), -1)
            for b in range(len(tv)):
                d = float((c_card[b] - c_cpu[b]).abs().max())
                cum_err = max(cum_err, d)
                gap = float((c_cpu[b] - u_cpu[b, 0]).abs().min())
                if gap < max(BOUNDARY, d):
                    near += 1
                    continue
                checked += 1
                if int(got[b]) != int(want[b]):
                    raise AssertionError(
                        f"sampled choice differs at call {n}, t={t}, row "
                        f"{b}: card {int(got[b])}, CPU {int(want[b])}")
    if checked == 0:
        raise AssertionError("no sampled choice was far from a boundary")
    return {"temperatures": temps.tolist(), "checked": checked,
            "near_boundary": near, "cum_max_abs_diff": cum_err,
            "boundary": BOUNDARY}


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
    "flash_attention_prefix": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:118"),
    "random_u32": ("src/repro_torch/kernels/csrc/drange.cu",
                   "src/repro/kernels/drange/drange.py:68"),
}
# the kernels each serving phase must launch
PHASE3_KERNELS = ("kv_scatter", "page_copy_batched", "page_init_batched",
                  "paged_attention", "flash_attention")
CHUNKED_KERNELS = ("kv_scatter", "page_init_batched", "paged_attention",
                   "flash_attention_prefix", "random_u32")


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
    cfg, params, init_s = granite_params(dev)
    counts, greedy = serving(dev, cfg, params, init_s)
    counts_chunked = serving_chunked(dev, cfg, params, greedy)
    emit(trace(dev, cfg, params))
    emit(chunked_vs_monolithic(dev, cfg, params))
    del params
    torch.cuda.empty_cache()
    emit(cross_check(dev))

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": counts[name] + counts_chunked[name],
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
