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
   (``library_ms``, a yardstick the port never calls); the Ambit
   kernels on the KV arena's layout, bit for bit, on one arena and on
   the (K, V) pair in one launch, including a batch whose destination
   is another op's source (one launch, staged in a thread-block
   cluster) and a page holding only a ``-0.0``, each time beside its
   goal; ``state_scatter`` on mamba2-1.3b's conv rows and 2 MiB
   SSD-state rows in one launch (the pair, as every step writes them)
   and each alone, bit for bit, beside the state arena's row copy and
   init and the state fork's copy of the conv/SSD pair in one launch;
   ``page_copy_batched`` on an overlapping batch (the cluster route) and
   a disjoint one (the direct route), each on one arena and the (K, V)
   pair, bit for bit before it is timed, with its bare launch and
   ``index_select`` + ``index_copy_`` (two calls); the attention kernels at jamba's 64/8 and llama4-scout's 40/8
   heads, with ptxas's registers and spills for each attention kernel
   and the count of tensor-core instructions in the built libraries'
   SASS (flash attention's must hold HMMA); rows 1, 4, 5 and 5p at one
   rank's shapes of phase 20(b) (16/4 heads, K/V rows of 512); the
   RowClone API's ``copy_2d`` and ``init_2d`` on granite-3-8b's full K arena (1.34 GB of bf16; ``init_2d`` also at an
   odd bf16 length and in int8) and ``page_copy`` / ``page_init`` on one
   layer of it, bit for bit, a chained batch and a duplicate
   destination included; the (K, V) pair forms of ``kv_scatter`` and
   ``page_init_batched`` bit for bit, timed against the two single
   calls they replace and two library calls, and the bare launches
   (``kernel_only_ms``) of ``kv_scatter``, ``page_copy_batched``,
   ``page_init_batched``, ``page_copy`` and ``page_init``;
13. RowClone against memcpy and calloc (run right after phase 2):
    ``pim_copy`` against ``Tensor.clone()`` and ``pim_init(..., 0)``
    against ``torch.zeros`` from 8 KiB to 1 GiB with each time's share
    of the memory rate and its ratio to the library call (the sizes of
    1 MiB or more where the kernel loses), then 40 layers of page
    copies and inits looped
    (40 launches of ``page_copy`` / ``page_init``) against batched
    (one); its launch counts are zeroed just before and read just
    after;
3. serving: granite-3-8b at full width and depth (40 layers, random
   bf16 weights from a seeded generator) answers 8 greedy requests
   through ``repro_torch.launch.serve.serve``, with a CoW fork of a live
   sequence (its copy flush one launch of the page-copy kernel, counted
   by the queue as two, one per arena, as the JAX package counts it)
   and its free between rounds; the kernel launch counts are
   zeroed just before and read just after, and every kernel of the path
   must have launched;
4. chunked serving: the same model and prompts under chunked prefill
   (256-token chunks), mixed rounds and 8-round decode blocks, requests
   4-7 arriving after the second step, even ids greedy and odd ids
   sampled at temperature 1.0, one with an EOS; its launch counts are
   zeroed and read around it, and mixed rounds, decode blocks, the
   generator and the prefix mode of flash attention must all have run;
5. trace: ``torch.profiler`` over the first chunk step, mixed round and
   decode block of the same workload that replay their graphs, the
   card's busy time by kernel group and the kernels it ran held equal
   to the launches the window counted, then
   over a replayed decode round and a replayed decode block of phase
   3's workload (each one replay of its captured graph: the host's
   calls that put work on the card against the device events it ran);
   then the same replays for mamba2-1.3b (phase 10's model and
   prompts);
6. chunked against monolithic prefill: first-token logits of the two
   paths at full depth, printed as drawn and held within ``LOGIT_ATOL``
   with every ``wq`` scaled by 0.01 (see the function);
7. cross-check: the same engine at full width and 2 layers on the card
   and on the CPU (plain versions) from identical weights, then the
   card's sampled token choice against the CPU's on identical logits;
8. prefix-cache serving (run after phase 4, before phase 5's profiler
   and phase 6, which scales the weights):
   the same model under chunked prefill, mixed rounds, 8-round blocks,
   the radix prefix cache and the Ambit zero scan — 4 tenants in turn
   on a 96-page arena that forces LRU evictions, then 16 requests of one
   system prompt through ``AsyncServer`` under Poisson arrivals — each
   ending in ``clear_prefix()`` and its zero audit;
9. ``TorchLib.bitwise`` through the op queue on a full-size arena pair:
   OR, AND and NOT batches, bit for bit, each flush one kernel launch
   over the pair while the queue counts one per arena (as the JAX
   package counts), so 2 / 1 launches of the bitwise / NOT kernels;
10. SSM serving (after phase 8; granite's weights are freed first and
    drawn again for phases 5 and 6, so every step time is taken before
    the profiler): mamba2-1.3b at full width and depth on a 256-row
    paged state arena, monolithic greedy with a fork (its KV tail and
    state row copies one launch each) and its free, one
    eager round whose state write goes through the op queue, then
    chunked with mixed rounds, 8-round blocks and sampled odd ids;
11. hybrid and MoE serving: jamba-1.5-large cut to one 4-layer period
    at full width (Mamba, attention, MoE and MLP sublayers), chunked
    with mixed rounds and blocks; llama4-scout cut to 2 layers at full
    width, monolithic;
12. mamba2-1.3b cut to 2 layers at full width on the card and on the
    CPU from identical weights: prefill and teacher-forced decode
    logits;
15. CUDA graphs (after phase 12, before phase 5's profiler): phase 3's
    workload on granite-3-8b, phase 4's chunked one on granite-3-8b and
    phase 10(a)'s on mamba2-1.3b, each at full width and depth, twice in
    one process — ``cuda_graphs=False`` then ``True`` — with identical
    streams, ``launches_by_kind`` deltas, kernel launch counts and
    step-cache misses required, every key met twice captured (a step is
    captured on its key's second use) and none met once; the decode-round
    medians, prefill milliseconds and TTFT, the chunk, mixed and block
    medians (also apart for first uses, captures and replays), the
    step-cache misses by counter, the seconds of the eager first uses
    and of the captures, and the graphs' pool; phase 8(b)'s open loop
    with graphs off then on (TTFT, ITL); a summary of each workload's
    prefill milliseconds and TTFT p99 with graphs off and on; and
    (printed after phase 5) each model's profiled replay;
14. trace and replay (after phase 8): phase 3's workload with
    ``record_trace=True`` at full depth (each kind's trace events equal
    its flushes), replayed on the simulated DDR3 prototype — its
    RowClone-vs-CPU totals and speedups are the prototype's
    nanoseconds, not the card's — then the same workload at 2 layers on
    the card and on the CPU, whose traces and replays must be equal;
16. the eager prefill oracle (after phase 6, on its weights: every
    ``wq`` scaled by 0.01): granite-3-8b at full width and depth serves
    phase 6's three prompts one at a time with ``fused_prefill=False``
    (each prompt through the dense forward, its KV through the op
    queue's ``kv_write``: the ``kv_scatter`` kernel), teacher-forced by
    the fused path's run of the same prompts: first-token logits within
    ``LOGIT_ATOL``, greedy choices equal where the fused margin exceeds
    ``MARGIN``, 0 pages at the end;
17. the dense forward (``models/transformer.forward``) of every family
    at 2 layers, the same weights on the card and on the CPU, both
    computing in float32 (TF32 off), every ``wq`` x 0.01 as in phase 6:
    granite, llava (with patch embeds),
    mamba2 and seamless (with frames) at full width; llama4-scout, the
    MLA deepseek and jamba at ``reduced()`` widths (their full-width
    expert layers would run expert-dense on the host CPU); logits held
    within ``FORWARD_RTOL`` of the largest |logit|, beside a probe of
    one float32 GEMM on the card against float64 on the host (the
    card's float32 matmul precision);
18. llava-next-34b at full width (60 layers, d_model 7168, 56/8 heads,
    d_ff 20480; 34.4 B parameters, 68.8 GB of bf16; the depth cut only
    if the card cannot hold it, printed with the bytes), served
    text-only from a 256-page arena: 4 greedy requests monolithic, then
    chunked (256) with mixed rounds, 8-round blocks and a sampled
    request; each run's decode round in ms against its bound (the
    weights and the KV read once) and its tokens/s;
19. training (last, on a free card): (a) one ``make_train_step`` step
    of gemma-2b reduced to 2 layers (width 256, vocab 4096) on the card
    and on the CPU from the same float32 weights, both computing in
    float32 (TF32 off), with remat "full" and "none": loss, grad norm
    and every updated parameter within ``TRAIN_*``; (b) gemma-2b at full
    width and depth (2.51 B parameters, float32 master weights, AdamW
    with float32 state, remat "full", attention tiles of 512) for 8
    steps over ``SyntheticLM`` at batch 4 x 2048: losses finite and
    falling, each step's ms (CUDA events) with the median of steps 3-8,
    tokens/s, peak memory, one step split into the layers' forward,
    ``fused_xent``'s forward and backward, the layers' backward and the
    optimizer, a profiled step's busy time by kernel group, one layer's
    attention beside SDPA's, and the model FLOPs' share of the bf16
    peak (both (a) and (b) draw the attention projections at their
    contraction's fan-in; (b) prints one step at the init rule's scales
    first); (c) at (a)'s size, a checkpoint written on the card reloads
    bit for bit, a ``Supervisor`` run with a failure at step 3 and
    checkpoints every 2 resumes from step 2 with the uninterrupted run's
    losses, and ``launch.train.main`` on the card does the same;
20. tensor-parallel serving over ``torch.distributed`` (each rank a fresh
    process, so the main process first frees what it holds): (a)
    granite-3-8b at full width and depth, phase 3's workload under
    ``mesh=make_local_mesh(model=1)`` over a one-rank NCCL group with
    the step graphs on (the collectives captured in them): streams equal
    phase 3's and the K/V arenas a host-local engine's bit for bit, one
    ``fused_decode`` a round, owner ``kv``, the decode round beside phase
    3's; then ``compressed_collectives=True`` under the margin rule; (b)
    minitron-8b at full width and depth (9.9 B parameters, 19.8 GB of
    bf16: 9.9 GB a rank) over two gloo ranks sharing the card (graphs
    off), 4 greedy requests monolithic and then chunked (256) with mixed
    rounds and 8-round blocks, teacher-forced by the same model served
    in this process first: logits within ``TP_LOGIT_ATOL`` and the margin
    rule, the ranks equal, each rank's K/V slice the one-process arenas'
    head slice (layer 0 bit for bit), one dispatch a round, owners
    ``kv/shard0``/``kv/shard1``; then the eager prefill oracle
    (``fused_prefill=False``) on the ranks' slices, the 4 requests one
    at a time, teacher-forced by the fused path in one process (logits
    within ``TP_EAGER_LOGIT_ATOL`` and its margin rule); its ms are two
    ranks time-sharing one card through host collectives, not a speed
    of tensor parallelism;
21. data-parallel training: (a) ``launch.train.main --data-axis 2
    --backend gloo`` (the ZeRO-3 layout) at 19(a)'s size against one
    process on the same global batch; (b) gemma-2b at full width over
    two gloo ranks with the state replicated, the depth cut (printed
    with the bytes) so two replicated copies of the training state fit
    the card, 3 steps at 4 x 2048; (c) ``compressed_grad_sync`` on CUDA
    tensors at world 1 over NCCL and world 2 over gloo, bit for bit with
    the quantization formula on the CPU;
22. ZeRO-3 training (``sharding_env(mesh, fsdp=True)``, the JAX
    launcher's layout): gemma-2b at full width over two gloo ranks, each
    holding its slices of the weights and AdamW's moments; (a) at 21(b)'s
    depth, its losses, grad norms and parameter checksums held against
    21(b)'s replicated run and its peak GB reserved a rank beside
    21(b)'s; (b) the deepest depth a two-rank probe at one and two
    layers allows, ``ZERO_STEPS`` steps; each rank's collective bytes by
    kind (``Mesh.collective_bytes``);
24. the JAX rule set's 2-D training layout (after phase 22, on its
    reference): gemma-2b at full width over four gloo ranks at
    ``{"data": 2, "model": 2}`` (its 8 heads, 16 384-wide MLP and
    256 000-token vocab split over ``model``, its one KV head whole, FSDP
    over ``data``), phase 22(a)'s depth, weights and global batch,
    ``RULE_TRAIN_STEPS`` steps: losses and grad norms against 22(a)'s
    ZeRO-3 run within ``RULE_TRAIN_*_RTOL``, the ranks equal, each
    rank's peak GB reserved beside 22(a)'s and its collective bytes by
    kind; then ``repro_torch.examples.serve_rowclone`` in a subprocess
    on the card.  The ``total`` line gives the whole run's seconds,
    phase 19's, phases 20-21's, phase 22's, phase 24's and phase 23's;
23. the dry run (``repro_torch.launch.dryrun.trace_cell``, last): five
    cells traced on the card as rank 0 of their production world under a
    fake process group, with real tensors at the rank's shapes —
    gemma-2b ``train_4k`` at ``{"data": 256, "model": 1}`` (ZeRO-3,
    forced) and in the JAX rule set's 2-D layout at ``{"data": 16,
    "model": 16}`` (its 8 heads whole over ``model``, its MLP and vocab
    split, 16 sequences a rank), minitron-8b ``decode_32k`` at
    ``{"data": 32, "model": 8}`` (the engine's tensor-parallel step,
    forced), and granite-3-8b and llama4-scout-17b-a16e ``decode_32k``
    in the rule set's serving layout at ``{"data": 16, "model": 16}``
    (granite's vocab and KV heads whole over ``model``, llama4's experts
    over it) — each with
    its argument GB and its peak allocated and reserved bytes above
    what the process held when the trace began (printed as the
    baseline) beside the record's argument bytes, ``analytic_memory`` and the card's
    80 GB, the step's ms (CUDA events; the fake collectives move nothing,
    so compute only) beside the rank's ``t_compute``, ``t_memory`` and
    ``t_bound`` from the traced flops and bytes, and the traced
    collective bytes by kind; the same cells traced on meta tensors must
    count the same flops and collective bytes.  It prints torch's version
    and fails if torch has no fake process group.

Every serving phase runs with the engine's default ``cuda_graphs=True``:
its prefill batches, chunk steps, mixed rounds (two graphs each), decode
rounds and K-block rounds run eagerly on a shape bucket's first use and
replay a graph captured on its second; each serving line prints its
step-cache misses, captures and graph pool.

The last lines are the card's ``nvidia-smi`` name and power limit, the
kernels' JSON summary, and ``{"ok": true, "device": {...}}``.  Without a
CUDA card, or without the rest of the repository beside it, the script
exits nonzero before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time
from array import array
from pathlib import Path
from typing import Optional

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
# phase 12: mamba2's first-step logits, card against CPU (|logit| < 4,
# bf16 spacing 2**-6 there: about three steps of the two rounding paths)
SSM_FIRST_ATOL = 0.05
# phase 7's sampled choice: uniforms within this of a CDF boundary may
# fall on either side of it (float32 cumulative sums in another order)
BOUNDARY = 1e-5
# phase 17: float32 logits of the card and the CPU, whose matmuls sum
# in other orders, relative to the largest |logit|: two layers of
# float32 sums over up to 20480 terms, each off by a few ulps, then the
# logits' own sums over d_model
FORWARD_RTOL = 2e-3


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


def time_ms_least(fn, repeats: int = 5) -> float:
    """The least of ``repeats`` :func:`time_ms` means: a host-bound
    wrapper's time without the host's pauses between its calls."""
    return min(time_ms(fn) for _ in range(repeats))


def bound(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    """The least time (ms) for ``nbytes`` of memory traffic and
    ``flops`` operations at ``peak`` operations/s, and which bounds."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def synchronize(dev) -> None:
    """Wait for the card's work on ``dev`` (nothing to wait for on the
    CPU, where the distributed phases also run at reduced sizes)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit equality of two tensors of one dtype (raw bytes)."""
    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


# ---------------------------------------------------------------------- #
# Phase 2: kernel parity at the serving path's shapes
# ---------------------------------------------------------------------- #


def bare_copy(arenas, lead, src, dst, stream):
    """The arguments of one bare ``rc_copy_pages`` launch (the op list in
    its parameters, as the wrapper passes it) of ops free of duplicate
    destinations on one arena or a pair (``lead`` 2: ``(L, P, ...)``; 1:
    ``(P, ...)``), on the route the wrapper picks, and that route."""
    from repro_torch.kernels.rowclone import ops as rc_ops

    desc, rows = [], []
    for a in arenas:
        L, P = (a.shape[0], a.shape[1]) if lead == 2 else (1, a.shape[0])
        rows.append(rc_ops._row_bytes(a, lead))
        desc += [a.data_ptr(), a.data_ptr(), P, P, rows[-1], L]
    route = "direct"
    if rc_ops._reads_a_write(src, dst):
        route = rc_ops.copy_route(rows, len(src), True)
    if route == "staged":
        raise AssertionError("a bare launch is one launch: the batch takes "
                             "the staged route")
    return (array("q", desc).tobytes(), len(arenas), None,
            array("i", src + dst).tobytes(), len(src), 0,
            1 if route == "cluster" else 0, stream), route


def page_copy_rows(dev, lib, arena, v_arena, work, work_v, overlapping,
                   disjoint) -> dict:
    """Phase 2's row 2, ``page_copy_batched`` at granite-3-8b's shape (40
    layers of 32 KiB pages): an overlapping batch (a destination that is
    another op's source: the cluster route) and a disjoint one (the
    direct route), each on one arena and on the (K, V) pair, bit for bit
    against the plain version before it is timed.  Timed: the wrapper
    (``ms``: the overlapping batch on one arena, as before), the bare
    launch (``kernel_only_ms``), the plain version, and the two calls
    ``index_select`` + ``index_copy_`` that compute the same function
    (``two_calls_library_ms``; no single call does); the pair as one
    launch against the two one-arena calls a flush made before."""
    from repro_torch.kernels.rowclone import ops as rc_ops
    from repro_torch.kernels.rowclone import ref as rc_ref

    stream = torch.cuda.current_stream(dev).cuda_stream
    for what, (src, dst) in (("overlapping", overlapping),
                             ("disjoint", disjoint)):
        s_t, d_t = torch.tensor(src), torch.tensor(dst)
        want = rc_ref.page_copy_batched(arena.clone(), s_t, d_t)
        got = rc_ops.pim_page_copy_batched(arena.clone(), src, dst)
        torch.cuda.synchronize()
        if not same_bits(got, want):
            raise AssertionError(f"page_copy_batched ({what}) disagrees "
                                 "with its plain version")
        del got
        want_v = rc_ref.page_copy_batched(v_arena.clone(), s_t, d_t)
        got, got_v = arena.clone(), v_arena.clone()
        rc_ops.pim_page_copy_batched_pair(got, got_v, src, dst)
        torch.cuda.synchronize()
        if not (same_bits(got, want) and same_bits(got_v, want_v)):
            raise AssertionError(f"page_copy_batched (pair, {what}) "
                                 "disagrees with its plain version")
        del want, got, want_v, got_v
    L, page_bytes = arena.shape[0], rc_ops._row_bytes(arena, 2)
    row = {"max_abs_err": 0.0}
    for what, (src, dst) in (("", overlapping), ("disjoint_", disjoint)):
        s_t = torch.tensor(src, device=dev)
        d_t = torch.tensor(dst, device=dev)
        nb, by = bound(2 * len(src) * L * page_bytes, 0)
        bare, route = bare_copy((work,), 2, src, dst, stream)
        bare_pair, _ = bare_copy((work, work_v), 2, src, dst, stream)
        row.update({
            f"{what}route": route,
            f"{what}ms": time_ms(
                lambda: rc_ops.pim_page_copy_batched(work, src, dst)),
            f"{what}kernel_only_ms": time_ms(
                lambda: lib.rc_copy_pages(*bare)),
            f"{what}plain_ms": time_ms(
                lambda: rc_ref.page_copy_batched(work, s_t, d_t)),
            f"{what}bound_ms": nb, f"{what}bound_by": by,
            f"{what}two_calls_library_ms": time_ms(
                lambda: work.index_copy_(1, d_t, work.index_select(1, s_t))),
            f"{what}pair_ms": time_ms(
                lambda: rc_ops.pim_page_copy_batched_pair(work, work_v, src,
                                                          dst)),
            f"{what}pair_kernel_only_ms": time_ms(
                lambda: lib.rc_copy_pages(*bare_pair)),
            f"{what}pair_bound_ms": 2 * nb,
            f"{what}pair_two_calls_ms": time_ms(lambda: (
                rc_ops.pim_page_copy_batched(work, src, dst),
                rc_ops.pim_page_copy_batched(work_v, src, dst)))})
    row["library_ms"] = None
    return row


def parity(dev) -> dict:
    from repro_torch.kernels import _build
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
    # the pair form: the V arena and its payload, pad rows duplicated too
    v_arena = randn(L, P, S, KVH, D)
    v_new = randn(L, B, KVH, D)
    v_new[:, 6] = v_new[:, 0]
    v_new[:, 7] = v_new[:, 1]
    want_v = rc_ref.kv_scatter(v_arena.clone().view(L, P, S, E), pages,
                               slots, v_new.view(L, B, E))
    got_k, got_v = arena.clone(), v_arena.clone()
    rc_ops.kv_scatter_pair_inline(got_k, got_v, pages, slots, new, v_new)
    torch.cuda.synchronize()
    if not (same_bits(got_k.view(L, P, S, E), want)
            and same_bits(got_v.view(L, P, S, E), want_v)):
        raise AssertionError("kv_scatter (pair) disagrees with its plain "
                             "version")
    del want, got, want_v, got_k, got_v
    work = arena.clone()
    work_v = v_arena.clone()
    flat = work.view(L, P * S, E)
    flat_v = work_v.view(L, P * S, E)
    flat_idx = (pages.long() * S + slots.long())
    nb, by = bound(2 * L * len(set(zip(pages_l, slots_l))) * E * 2
                   + 2 * B * 4, 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc_lib = _build.load("rowclone")
    # the bare launches: one arena, and the (K, V) pair
    bare = (work.data_ptr(), work.data_ptr(), new.data_ptr(), new.data_ptr(),
            1, pages.data_ptr(), slots.data_ptr(), L, B, P, S, E * 2, stream)
    bare_pair = (work.data_ptr(), work_v.data_ptr(), new.data_ptr(),
                 v_new.data_ptr(), 2, pages.data_ptr(), slots.data_ptr(), L,
                 B, P, S, E * 2, stream)
    # every serving caller writes a (K, V) pair in one launch, so the row
    # reports the pair form; the one-arena call and the two one-arena
    # calls the pair replaced stand beside it
    rows["kv_scatter"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: rc_ops.kv_scatter_pair_inline(
            work, work_v, pages, slots, new, v_new)),
        kernel_only_ms=time_ms(lambda: rc_lib.rc_kv_scatter(*bare_pair)),
        plain_ms=time_ms(lambda: rc_ref.kv_scatter_pair(
            work.view(L, P, S, E), work_v.view(L, P, S, E), pages, slots,
            new.view(L, B, E), v_new.view(L, B, E))),
        bound_ms=2 * nb, bound_by=by,
        library_ms=time_ms(lambda: (
            flat.index_copy_(1, flat_idx, new.view(L, B, E)),
            flat_v.index_copy_(1, flat_idx, v_new.view(L, B, E)))),
        one_arena_ms=time_ms(lambda: rc_ops.kv_scatter_inline(
            work, pages, slots, new)),
        one_arena_kernel_only_ms=time_ms(lambda: rc_lib.rc_kv_scatter(
            *bare)),
        one_arena_bound_ms=nb,
        one_arena_library_ms=time_ms(lambda: flat.index_copy_(
            1, flat_idx, new.view(L, B, E))),
        two_calls_ms=time_ms(lambda: (
            rc_ops.kv_scatter_inline(work, pages, slots, new),
            rc_ops.kv_scatter_inline(work_v, pages, slots, v_new))))
    del flat_v

    # -- page copy / init: 16 ops, one op's dst is another op's src
    src = list(range(100, 116))
    dst = list(range(200, 215)) + [100]   # op 15 writes what op 0 reads
    page_bytes = S * E * 2
    rows["page_copy_batched"] = page_copy_rows(
        dev, rc_lib, arena, v_arena, work, work_v, (src, dst),
        (list(range(300, 316)), list(range(400, 416))))
    init_pages = dst
    want = rc_ref.page_init_batched(arena.clone(),
                                    torch.tensor(init_pages), 0.0)
    got = rc_ops.pim_page_init_batched(arena.clone(), init_pages, 0.0)
    torch.cuda.synchronize()
    if not same_bits(got, want):
        raise AssertionError("page_init_batched disagrees with its plain "
                             "version")
    want_v = rc_ref.page_init_batched(v_arena.clone(),
                                      torch.tensor(init_pages), 0.0)
    got, got_v = arena.clone(), v_arena.clone()
    rc_ops.pim_page_init_batched_pair(got, got_v, init_pages, 0.0)
    torch.cuda.synchronize()
    if not (same_bits(got, want) and same_bits(got_v, want_v)):
        raise AssertionError("page_init_batched (pair) disagrees with its "
                             "plain version")
    del want, got, want_v, got_v
    init_idx = torch.tensor(init_pages, device=dev)
    nb, by = bound(len(init_pages) * L * page_bytes, 0)
    # the bare launches, the page list in their parameters as the
    # wrapper passes it
    init_host = np.asarray(init_pages, np.int32)
    bare = (work.data_ptr(), work.data_ptr(), 1, None, init_host.ctypes.data,
            P, len(init_pages), L, page_bytes, 0, stream)
    bare_pair = (work.data_ptr(), work_v.data_ptr(), 2, None,
                 init_host.ctypes.data, P, len(init_pages), L, page_bytes, 0,
                 stream)
    rows["page_init_batched"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: rc_ops.pim_page_init_batched(work, init_pages,
                                                        0.0)),
        kernel_only_ms=time_ms(lambda: rc_lib.rc_init_rows(*bare)),
        plain_ms=time_ms(lambda: rc_ref.page_init_batched(work, init_idx,
                                                          0.0)),
        bound_ms=nb, bound_by=by,
        library_ms=time_ms(lambda: work.index_fill_(1, init_idx, 0.0)),
        # the queue's flush of a (K, V) pair: one launch, one upload
        pair_ms=time_ms(lambda: rc_ops.pim_page_init_batched_pair(
            work, work_v, init_pages, 0.0)),
        pair_kernel_only_ms=time_ms(lambda: rc_lib.rc_init_rows(
            *bare_pair)),
        two_calls_ms=time_ms(lambda: (
            rc_ops.pim_page_init_batched(work, init_pages, 0.0),
            rc_ops.pim_page_init_batched(work_v, init_pages, 0.0))),
        pair_bound_ms=2 * nb,
        library_pair_ms=time_ms(lambda: (
            work.index_fill_(1, init_idx, 0.0),
            work_v.index_fill_(1, init_idx, 0.0))))
    del work, work_v, flat, arena, v_arena

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
    # the bare launch, its operands already made (no wrapper host work)
    npart = pa_ops.num_partitions(width, S)
    o_bare = torch.empty_like(q)
    scratch = torch.empty((B, KVH, npart, H // KVH, D + 2),
                          dtype=torch.float32, device=dev)
    bare = (q.data_ptr(), k_ar.data_ptr(), v_ar.data_ptr(), bt.data_ptr(),
            lens.data_ptr(), k_self.data_ptr(), v_self.data_ptr(),
            o_bare.data_ptr(), None, None, scratch.data_ptr(),
            pa_ops._tickets(dev, B * KVH).data_ptr(), B, H, KVH, D, S,
            width, npart, pa_ops.PARTITION_TOKENS, D ** -0.5, 0,
            torch.cuda.current_stream(dev).cuda_stream)
    pa_lib = _build.load("paged_attention")
    rows["paged_attention"] = dict(
        max_abs_err=err,
        kernel_only_ms=time_ms(lambda: pa_lib.pa_paged_attention(*bare)),
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
    fa_lib = _build.load("flash_attention")
    stream = torch.cuda.current_stream(dev).cuda_stream
    o_bare = torch.empty_like(qf)
    bare = (qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), flens.data_ptr(),
            None, None, None, o_bare.data_ptr(), Bf, H, KVH, Sf, Sf, 0, D, 1,
            D ** -0.5, 0, 0, 0, 0, stream)
    rows["flash_attention"] = dict(
        max_abs_err=err,
        kernel_only_ms=time_ms(lambda: fa_lib.fa_flash_attention(*bare),
                               iters=10),
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
    o_bare = torch.empty_like(qc)
    bare = (qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), clens.data_ptr(),
            kp.data_ptr(), vp.data_ptr(), plens.data_ptr(), o_bare.data_ptr(),
            Bf, H, KVH, Sc, Sc, W * S, D, 1, D ** -0.5, 0, *kp.stride()[:3],
            stream)
    rows["flash_attention_prefix"] = dict(
        max_abs_err=err,
        kernel_only_ms=time_ms(lambda: fa_lib.fa_flash_attention(*bare),
                               iters=10),
        ms=time_ms(lambda: fa_ops.attention(qc, kc, vc, **pkw), iters=10),
        plain_ms=time_ms(lambda: fa_ref.attention(qc, kc, vc, **pkw),
                         iters=10),
        bound_ms=nb, bound_by=by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qc, kcat, vcat, attn_mask=pmask), iters=10))
    del kcat, vcat, k_ar, v_ar, kp, vp

    # -- random_u32: the words and the uniform draw, bit for bit, at the
    # sampled path's (8, 1) (the draw's pad rows folded by a row map, as
    # a K-block folds them) and at (4096, 256).  The row's times are the
    # serving draw's (one launch of the uniform kernel); beside them the
    # words' wrapper and the draw as the path made it before (the words,
    # four elementwise passes and the row map's gather)
    dr_lib = _build.load("drange")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rowmap8 = torch.tensor([0, 1, 2, 3, 4, 5, 0, 0], device=dev)
    for shape in ((4096, 256), (8, 1)):
        seed = (0x9E3779B9, 12345)
        rm = rowmap8 if shape == (8, 1) else None

        def old_draw():
            bits = dr_ops.pim_random_u32(seed, *shape,
                                         device=dev).view(torch.int32)
            u = ((bits >> 8) & 0xFFFFFF).to(torch.float32) \
                * (1.0 / (1 << 24))
            return u if rm is None else u[rm]

        got = dr_ops.pim_random_u32(seed, *shape, device=dev)
        want = dr_ref.random_u32(seed, *shape, dev)
        got_u = dr_ops.pim_random_uniform(seed, *shape, dev, rowmap=rm)
        want_u = dr_ref.random_uniform(seed, *shape, dev, rowmap=rm)
        old_u = old_draw()
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want):
            raise AssertionError(f"random_u32 {shape} disagrees with its "
                                 "plain version")
        if not (same_bits(got_u, want_u) and same_bits(got_u, old_u)):
            raise AssertionError(f"the uniform draw {shape} disagrees with "
                                 "its plain version or the words' uniforms")
        n = shape[0] * shape[1]
        n_out = got_u.numel()
        # each output word: the generator's operations, then the shift,
        # the conversion and the scale
        nb, by = bound(4 * n_out + (0 if rm is None else 8 * rm.numel()),
                       (U32_OPS_PER_WORD + 3) * n_out, CUDA_CORE_OPS)
        nb_w = bound(4 * n, U32_OPS_PER_WORD * n, CUDA_CORE_OPS)[0]
        out_u = torch.empty_like(got_u)
        bare = (*seed, out_u.data_ptr(), n_out, shape[1],
                None if rm is None else rm.data_ptr(), stream)
        rows["random_u32" if shape == (8, 1) else "random_u32_4096x256"] = \
            dict(max_abs_err=0.0, shape=list(shape),
                 row_map=None if rm is None else rm.tolist(),
                 ms=time_ms(lambda: dr_ops.pim_random_uniform(
                     seed, *shape, dev, rowmap=rm)),
                 kernel_only_ms=time_ms(lambda: dr_lib.dr_random_uniform(
                     *bare)),
                 plain_ms=time_ms(lambda: dr_ref.random_uniform(
                     seed, *shape, dev, rowmap=rm)),
                 bound_ms=nb, bound_by=by, library_ms=None,
                 old_draw_ms=time_ms(old_draw),
                 words_ms=time_ms(lambda: dr_ops.pim_random_u32(
                     seed, *shape, device=dev)),
                 words_plain_ms=time_ms(lambda: dr_ref.random_u32(
                     seed, *shape, dev)),
                 words_bound_ms=nb_w)
    rows.update(ambit_parity(dev, randn, L, P, S, E))
    rows.update(ssm_parity(dev))
    rows.update(ssd_step_parity(dev))
    rows["attention_hybrid_heads"] = attention_heads_parity(dev, randn)
    rows["per_rank_minitron_world2"] = rank_shapes_parity(dev, randn)
    rows["attention_build"] = attention_build_info()
    return rows


def bare_bitwise(arenas, src, dst, op, stream):
    """The arguments of one bare ``am_page_rows`` launch of ``op`` (the op
    list in its parameters, as the wrapper passes it) on one arena or a
    pair, on the route the wrapper picks, and that route."""
    from repro_torch.kernels.ambit import ops as amb_ops
    from repro_torch.kernels.rowclone import ops as rc_ops

    desc, rows = [], []
    for a in arenas:
        rows.append(rc_ops._row_bytes(a, 2))
        desc += [a.data_ptr(), a.data_ptr(), a.shape[1], a.shape[1],
                 rows[-1], a.shape[0]]
    route = "direct"
    if rc_ops._reads_a_write(src, dst):
        route = rc_ops.copy_route(rows, len(src), True,
                                  amb_ops.cluster_chunks())
    if route == "staged":
        raise AssertionError("a bare launch is one launch: the batch takes "
                             "the staged route")
    return (array("q", desc).tobytes(), len(arenas), None,
            array("i", src + dst).tobytes(), len(src), 0,
            1 if route == "cluster" else 0, amb_ops._OP_CODE[op],
            stream), route


# rows 8-9's goals (ms), stated before their first timing on the card
AMBIT_GOALS = {"and": {"ms": 0.03, "pair_ms": 0.05, "overlapping_ms": 0.04},
               "or": {"ms": 0.03, "pair_ms": 0.05, "overlapping_ms": 0.04},
               "not": {"ms": 0.025, "pair_ms": 0.04,
                       "overlapping_ms": 0.04}}


def ambit_parity(dev, randn, L, P, S, E) -> dict:
    """The Ambit kernels on the KV arena's layout (40, 1024, 16 x 8 x
    128) bf16, batches of 16 pages, bit for bit against their plain
    versions: AND, OR and NOT on one arena and on the (K, V) pair in one
    launch, each on a disjoint batch (the direct route) and on a batch
    whose last op writes the page its first op reads (the cluster route:
    one launch, where two did before); the scan of one arena and of a
    (K, V) pair over pages holding zeros, one planted ``-0.0`` (nonzero
    bits), a page nonzero only in V and random values.  Times: the
    wrapper on one arena (``ms``, the disjoint batch), on the
    overlapping batch and on the pair (against the two one-arena calls
    a flush made before), each with its bare launch (``kernel_only_ms``:
    the op list in the launch's parameters, as the wrapper passes it),
    beside each goal of ``AMBIT_GOALS``.  Bounds: 3 page reads or writes
    per op for AND/OR, 2 for NOT; for the scan, every byte of a page
    found zero and one word of each other page (it stops at the first
    set bit).  No single PyTorch call computes a gathered page op
    (``library_ms`` null); ``library_sequence_ms`` times the calls that
    do: ``index_select`` of the sources (AND/OR: and of the
    destinations), ``torch.bitwise_and``/``_or``/``_not`` and
    ``index_copy_``.  The scan's library yardstick is ``(x != 0)``
    reduced per page over the pages gathered beforehand."""
    from repro_torch.kernels import _build, launch_counts, reset_launches
    from repro_torch.kernels.ambit import ops as amb_ops
    from repro_torch.kernels.ambit import ref as amb_ref

    rows = {}
    arena = randn(L, P, S, E)
    v_arena = randn(L, P, S, E)
    page_bytes = S * E * 2
    lib = _build.load("ambit")
    stream = torch.cuda.current_stream(dev).cuda_stream
    src = list(range(300, 316))
    disjoint = list(range(400, 416))
    overlapping = list(range(500, 515)) + [300]  # op 15 writes op 0's source
    lib_fn = {"and": torch.bitwise_and, "or": torch.bitwise_or}

    def plain(a, s, d, op):
        if op == "not":
            return amb_ref.page_not_batched(a, s, d)
        return amb_ref.page_bitwise_batched(a, s, d, op)

    for op, name in (("and", "page_bitwise_batched"),
                     ("or", "page_bitwise_batched_or"),
                     ("not", "page_not_batched")):
        for what, dst in (("disjoint", disjoint),
                          ("overlapping", overlapping)):
            s_t, d_t = torch.tensor(src, device=dev), \
                torch.tensor(dst, device=dev)
            want = plain(arena.clone(), s_t, d_t, op)
            want_v = plain(v_arena.clone(), s_t, d_t, op)
            got = arena.clone()
            reset_launches()
            amb_ops.pim_page_bitwise_batched(got, src, dst, op=op)
            torch.cuda.synchronize()
            one = sum(launch_counts().values())
            if not same_bits(got, want) or one != 1:
                raise AssertionError(f"{name} ({op}, {what}) disagrees with "
                                     f"its plain version or made {one} "
                                     "launches")
            got_v = v_arena.clone()
            got.copy_(arena)
            reset_launches()
            amb_ops.pim_page_bitwise_batched_pair(got, got_v, src, dst,
                                                  op=op)
            torch.cuda.synchronize()
            pair = sum(launch_counts().values())
            if not (same_bits(got, want) and same_bits(got_v, want_v)) \
                    or pair != 1:
                raise AssertionError(f"{name} (pair, {op}, {what}) disagrees "
                                     "with its plain version or made "
                                     f"{pair} launches")
            del want, want_v, got, got_v
        work, work_v = arena.clone(), v_arena.clone()
        s_t = torch.tensor(src, dtype=torch.long, device=dev)
        d_t = torch.tensor(disjoint, dtype=torch.long, device=dev)
        bits = work.view(torch.int16)
        n_rw = 2 if op == "not" else 3
        nb, by = bound(n_rw * len(src) * L * page_bytes + 8 * len(src), 0)
        bare, route = bare_bitwise((work,), src, disjoint, op, stream)
        bare_over, over_route = bare_bitwise((work,), src, overlapping, op,
                                             stream)
        bare_pair, _ = bare_bitwise((work, work_v), src, disjoint, op,
                                    stream)
        if op == "not":
            def sequence():
                bits.index_copy_(1, d_t, torch.bitwise_not(
                    bits.index_select(1, s_t)))
        else:
            def sequence():
                bits.index_copy_(1, d_t, lib_fn[op](
                    bits.index_select(1, s_t), bits.index_select(1, d_t)))
        row = dict(
            max_abs_err=0.0, pages=len(src), op=op, route=route,
            overlapping_route=over_route,
            timing="least of 5 means of 20 back-to-back calls",
            ms=time_ms_least(lambda: amb_ops.pim_page_bitwise_batched(
                work, src, disjoint, op=op)),
            kernel_only_ms=time_ms_least(lambda: lib.am_page_rows(*bare)),
            overlapping_ms=time_ms_least(
                lambda: amb_ops.pim_page_bitwise_batched(
                    work, src, overlapping, op=op)),
            overlapping_kernel_only_ms=time_ms_least(
                lambda: lib.am_page_rows(*bare_over)),
            pair_ms=time_ms_least(
                lambda: amb_ops.pim_page_bitwise_batched_pair(
                    work, work_v, src, disjoint, op=op)),
            pair_kernel_only_ms=time_ms_least(lambda: lib.am_page_rows(
                *bare_pair)),
            pair_overlapping_ms=time_ms_least(
                lambda: amb_ops.pim_page_bitwise_batched_pair(
                    work, work_v, src, overlapping, op=op)),
            pair_two_calls_ms=time_ms_least(lambda: (
                amb_ops.pim_page_bitwise_batched(work, src, disjoint, op=op),
                amb_ops.pim_page_bitwise_batched(work_v, src, disjoint,
                                                 op=op))),
            plain_ms=time_ms(lambda: plain(work, s_t, d_t, op)),
            bound_ms=nb, bound_by=by, pair_bound_ms=2 * nb,
            library_ms=None, library_sequence_ms=time_ms(sequence))
        row["goals"] = {k: {"goal_ms": g, "ms": row[k], "met": row[k] <= g}
                        for k, g in AMBIT_GOALS[op].items()}
        rows[name] = row
        del work, work_v, bits
    del v_arena
    # the scan of the (K, V) pair: zero pages, a -0.0 planted in K's last
    # layer (page 3), a page nonzero only in V (page 5), random pages
    zero = torch.zeros_like(arena)
    zero_v = torch.zeros_like(arena)
    pages = list(range(600, 616))
    zero[:, pages[8:]] = arena[:, pages[8:]]
    zero_v[:, pages[8:]] = arena[:, pages[8:]]
    zero[L - 1, pages[3], S - 1, E - 1] = -0.0
    zero_v[0, pages[5], 0, 0] = 1.0
    assert zero[L - 1, pages[3]].view(torch.int16).ne(0).any()
    p_t = torch.tensor(pages, dtype=torch.int32, device=dev)
    want = amb_ref.page_zero_scan(zero, p_t)
    got = amb_ops.pim_page_zero_scan(zero, pages)
    want_pair = amb_ref.page_zero_scan_pair(zero, zero_v, p_t)
    got_pair = amb_ops.pim_page_zero_scan_pair(zero, zero_v, pages)
    torch.cuda.synchronize()
    expect = [i < 8 and i != 3 for i in range(16)]
    expect_pair = [i < 8 and i not in (3, 5) for i in range(16)]
    if not (torch.equal(got, want) and want.tolist() == expect):
        raise AssertionError(f"page_zero_scan {got.tolist()} disagrees with "
                             f"its plain version {want.tolist()} or with "
                             f"{expect}")
    if not (got_pair.tolist() == want_pair.tolist() == expect_pair):
        raise AssertionError(f"page_zero_scan (pair) {got_pair.tolist()} "
                             "disagrees with its plain version "
                             f"{want_pair.tolist()} or with {expect_pair}")
    gz = zero.view(torch.int16)[:, pages].contiguous()
    gv = zero_v.view(torch.int16)[:, pages].contiguous()
    n = len(pages)

    def library(g):
        return g.ne(0).transpose(0, 1).reshape(n, -1).any(dim=1)

    # what this run's data needs: every byte of a page found zero (in
    # each arena scanned), one 16-byte word of each other page; the page
    # list in, the flags out
    nb, by = bound(sum(expect_pair) * 2 * L * page_bytes
                   + 16 * (n - sum(expect_pair)) + 5 * n, 0)
    nb_one, by_one = bound(sum(expect) * L * page_bytes
                           + 16 * (n - sum(expect)) + 5 * n, 0)
    scratch = amb_ops._scratch(zero, stream, n)
    out_dev = torch.empty(n, dtype=torch.bool, device=dev)
    host_idx = np.asarray(pages, np.int32)
    bare_pair = (zero.data_ptr(), zero_v.data_ptr(), 2, None,
                 host_idx.ctypes.data, P, n, L, page_bytes,
                 scratch.data_ptr(), out_dev.data_ptr(), None, stream)
    bare_one = (zero.data_ptr(), zero.data_ptr(), 1, None,
                host_idx.ctypes.data, P, n, L, page_bytes,
                scratch.data_ptr(), out_dev.data_ptr(), None, stream)
    # the serving path's scan is the pair's (one launch, the flags in
    # host memory after one wait); a call's time includes that wait
    rows["page_zero_scan"] = dict(
        max_abs_err=0.0, pages=n, planted_negative_zero=True,
        nonzero_only_in_v=True,
        ms=time_ms(lambda: amb_ops.pim_page_zero_scan_pair(zero, zero_v,
                                                           pages)),
        kernel_only_ms=time_ms(lambda: lib.am_zero_scan(*bare_pair)),
        plain_ms=time_ms(lambda: amb_ref.page_zero_scan_pair(zero, zero_v,
                                                             p_t)),
        bound_ms=nb, bound_by=by,
        full_read_bound_ms=bound(n * 2 * L * page_bytes + 5 * n, 0)[0],
        library_ms=time_ms(lambda: library(gz) & library(gv)),
        # the cache's scan before: two single-arena calls, their AND and
        # the flags' copy to the host
        two_calls_ms=time_ms(lambda: (
            amb_ops.pim_page_zero_scan(zero, pages)
            & amb_ops.pim_page_zero_scan(zero_v, pages)).cpu()),
        one_arena_ms=time_ms(lambda: amb_ops.pim_page_zero_scan(zero,
                                                                pages)),
        one_arena_kernel_only_ms=time_ms(lambda: lib.am_zero_scan(
            *bare_one)),
        one_arena_plain_ms=time_ms(lambda: amb_ref.page_zero_scan(zero,
                                                                  p_t)),
        one_arena_bound_ms=nb_one,
        one_arena_library_ms=time_ms(lambda: library(gz)))
    del zero_v, gv
    del zero, arena, gz
    return rows


def ssm_parity(dev) -> dict:
    """``state_scatter`` on mamba2-1.3b's decode shapes, bit for bit
    against its plain version: the conv window (48 layers, 16 rows of 3
    x 4352 bf16, 26,112 B) and the SSD state (48 layers, 16 rows of 64 x
    64 x 128 float32, 2 MiB), 8 rows whose last duplicates the first in
    place with an identical payload, a lone ``-0.0`` planted in each
    payload; the pair in one launch (the serving path's: rows on the
    card, as a captured step holds them, and host rows in the launch's
    parameters, as the eager flush passes them) and each arena alone.
    Timed: the pair's wrapper (``ms``), its bare launch
    (``kernel_only_ms``), the two one-arena calls a step made before
    (``two_calls_ms``), each arena alone (wrapper and bare), the plain
    version, and ``index_copy_`` as the library call (one per arena).
    Bound: the payloads read once and the 7 distinct rows of each
    written once.  Beside it, the state arena's copy-on-fork and
    init-on-free (RowClone batched kernels on the (L, R, E) view) at
    2 MiB rows: one row (a fork, a free) and 8 rows."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssm_scan import ops as ss_ops
    from repro_torch.kernels.ssm_scan import ref as ss_ref

    gen = torch.Generator(device=dev).manual_seed(3)
    rows_out = {}
    L, R, B = 48, 16, 8
    rows_l = [3, 0, 15, 7, 9, 12, 5, 3]      # the last pads the first
    rows = torch.tensor(rows_l, dtype=torch.int32, device=dev)
    lib = _build.load("ssm_scan")
    stream = torch.cuda.current_stream(dev).cuda_stream
    shapes = {"conv": (3 * 4352, torch.bfloat16),
              "ssm": (64 * 64 * 128, torch.float32)}
    arenas, news = {}, {}
    for name, (E, dtype) in shapes.items():
        arenas[name] = torch.randn((L, 1, R, E), generator=gen, device=dev,
                                   dtype=dtype)
        new = torch.randn((L, 1, B, E), generator=gen, device=dev,
                          dtype=dtype)
        new[:, :, B - 1] = new[:, :, 0]
        new[L - 1, 0, 2, E - 1] = -0.0
        news[name] = new
    names = tuple(shapes)
    want = {n: ss_ref.state_scatter(arenas[n].clone().view(L, R, -1), rows,
                                    news[n].view(L, B, -1)) for n in names}

    def check(got, what):
        torch.cuda.synchronize()
        for n, g in got.items():
            if not same_bits(g.view(L, R, -1), want[n]):
                raise AssertionError(f"state_scatter ({what}, {n}) "
                                     "disagrees with its plain version")
            bits = torch.int16 if g.dtype == torch.bfloat16 else torch.int32
            if g.view(L, R, -1)[L - 1, rows_l[2], -1].view(bits).item() == 0:
                raise AssertionError("the planted -0.0 lost its sign bit")

    for what, idx in (("pair, rows on the card", rows),
                      ("pair, host rows", rows_l)):
        got = {n: arenas[n].clone() for n in names}
        ss_ops.state_scatter_pair_inline(got["conv"], got["ssm"], idx,
                                         news["conv"], news["ssm"])
        check(got, what)
        del got
    for n in names:
        got = {n: arenas[n].clone()}
        ss_ops.state_scatter_inline(got[n], rows, news[n])
        check(got, "one arena")
        del got
    del want
    work = {n: arenas[n].clone() for n in names}
    flat = {n: work[n].view(L, R, -1) for n in names}
    row_bytes = {n: E * dtype.itemsize for n, (E, dtype) in shapes.items()}

    def desc(ns):
        return array("q", [v for n in ns for v in (
            work[n].data_ptr(), news[n].data_ptr(), R, row_bytes[n],
            L)]).tobytes()

    def nbytes(ns):
        return sum(L * B * row_bytes[n] + L * len(set(rows_l)) * row_bytes[n]
                   for n in ns) + 4 * B

    idx = rows.long()
    pair_desc = desc(names)
    nb, by = bound(nbytes(names), 0)
    row = dict(
        arenas={n: [L, R, shapes[n][0]] for n in names},
        dtypes={n: str(shapes[n][1]).split(".")[-1] for n in names},
        rows=B, max_abs_err=0.0,
        ms=time_ms(lambda: ss_ops.state_scatter_pair_inline(
            work["conv"], work["ssm"], rows, news["conv"], news["ssm"])),
        host_rows_ms=time_ms(lambda: ss_ops.state_scatter_pair_inline(
            work["conv"], work["ssm"], rows_l, news["conv"], news["ssm"])),
        kernel_only_ms=time_ms(lambda: lib.ss_state_scatter(
            pair_desc, 2, rows.data_ptr(), None, B, stream)),
        two_calls_ms=time_ms(lambda: [ss_ops.state_scatter_inline(
            work[n], rows, news[n]) for n in names]),
        plain_ms=time_ms(lambda: [ss_ref.state_scatter(
            flat[n], rows, news[n].view(L, B, -1)) for n in names]),
        bound_ms=nb, bound_by=by,
        library_ms=time_ms(lambda: [flat[n].index_copy_(
            1, idx, news[n].view(L, B, -1)) for n in names]))
    for n in names:
        one_desc = desc((n,))
        nb_n, by_n = bound(nbytes((n,)), 0)
        row[n] = dict(
            ms=time_ms(lambda: ss_ops.state_scatter_inline(work[n], rows,
                                                           news[n])),
            ms_least=time_ms_least(lambda: ss_ops.state_scatter_inline(
                work[n], rows, news[n])),
            kernel_only_ms=time_ms(lambda: lib.ss_state_scatter(
                one_desc, 1, rows.data_ptr(), None, B, stream)),
            plain_ms=time_ms(lambda: ss_ref.state_scatter(
                flat[n], rows, news[n].view(L, B, -1))),
            bound_ms=nb_n, bound_by=by_n,
            library_ms=time_ms(lambda: flat[n].index_copy_(
                1, idx, news[n].view(L, B, -1))))
    # copy-on-fork and init-on-free on the 2 MiB rows
    for n in (1, 8):
        src, dst = list(range(n)), list(range(R - n, R))
        rb = row_bytes["ssm"]
        nb_c, _ = bound(2 * L * n * rb, 0)
        nb_i, _ = bound(L * n * rb, 0)
        bare, _ = bare_copy((flat["ssm"],), 2, src, dst, stream)
        rows_out[f"state_copy_{n}_rows"] = dict(
            ms=time_ms(lambda: ss_ops.pim_state_copy(work["ssm"], src,
                                                     dst)),
            kernel_only_ms=time_ms(
                lambda: _build.load("rowclone").rc_copy_pages(*bare)),
            bound_ms=nb_c, bound_by="bytes")
        rows_out[f"state_init_{n}_rows"] = dict(
            ms=time_ms(lambda: ss_ops.pim_state_init(work["ssm"], dst,
                                                     0.0)),
            bound_ms=nb_i, bound_by="bytes")
    del work, flat, arenas, news
    rows_out.update(state_pair_rows(dev, gen, L, R))
    return {"state_scatter": row, "state_rows": rows_out}


def ssd_step_parity(dev) -> dict:
    """``ssd_step`` on mamba2-1.3b's decode shape, one Mamba sublayer: 64
    heads x 64 x 128 float32 state rows (2 MiB) in a 96-row arena, 64
    batch rows (60 real and 4 pads folded onto row 0, the bench's decode
    bucket) and 8 (7 and a pad); x, B and C bf16 views of one conv
    output.  The new state bit for bit against the plain ops (the
    gather, the SSD step, the alive mask with a dead row, the row fold),
    y within float32's bound for two 128-term dot products.  Timed
    without the mask, as a decode round runs it: the wrapper (``ms``),
    its bare launch (``kernel_only_ms``), the plain ops (``plain_ms``).
    Bound: each batch row's state read once and written once, x, B, C,
    dt and y beside."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssm_scan import ops as ss_ops
    from repro_torch.kernels.ssm_scan import ref as ss_ref

    gen = torch.Generator(device=dev).manual_seed(4)
    H, P, N, R = 64, 64, 128, 96
    arena = torch.randn((R, H, P, N), generator=gen, device=dev)
    lib = _build.load("ssm_scan")
    stream = torch.cuda.current_stream(dev).cuda_stream
    out_rows = {}
    for Bp, n in ((64, 60), (8, 7)):
        order = torch.randperm(R, generator=gen, device=dev)[:n].tolist()
        rows = torch.tensor(order + [order[0]] * (Bp - n),
                            dtype=torch.int32, device=dev)
        rowmap = torch.tensor(list(range(n)) + [0] * (Bp - n), device=dev)
        alive = torch.ones(Bp, dtype=torch.bool, device=dev)
        alive[1] = False
        xbc = torch.randn((Bp, 1, H * P + 2 * N), generator=gen,
                          device=dev).to(torch.bfloat16)
        xx, B, C = torch.split(xbc, [H * P, N, N], dim=-1)
        ops = dict(arena=arena, rows=rows, rowmap=rowmap, alive=alive,
                   x=xx.reshape(Bp, 1, H, P)[:, 0],
                   dt=torch.rand((Bp, H), generator=gen, device=dev) * 0.5,
                   A=-torch.rand(H, generator=gen, device=dev) * 2 - 0.1,
                   B=B[:, 0], C=C[:, 0],
                   out=torch.empty((Bp, H, P, N), device=dev))
        want_out = torch.empty_like(ops["out"])
        for mask in (alive, None):
            ops["alive"] = mask
            y = ss_ops.ssd_step_rows(**ops)
            want_y = ss_ref.ssd_step_rows(**{**ops, "out": want_out})
            torch.cuda.synchronize()
            if not same_bits(ops["out"], want_out):
                bad = (ops["out"] != want_out).sum().item()
                raise AssertionError(f"ssd_step ({Bp} rows): {bad} state "
                                     "values differ from the plain ops")
            new = ss_ref.ssd_step(ops["x"][:, None], ops["dt"][:, None],
                                  ops["A"], ops["B"][:, None],
                                  ops["C"][:, None],
                                  arena[rows.long()])[1]
            mag = torch.einsum("bn,bhpn->bhp", ops["C"].float().abs(),
                               new.abs())
            err = (y - want_y).abs()
            rel = float((err / mag.clamp_min(1e-30)).max())
            if rel > 2 * N * 2.0 ** -24:
                raise AssertionError(f"ssd_step ({Bp} rows): y off by "
                                     f"{rel:.3g} of sum |C new|")
            del new, mag
        bare = (arena.data_ptr(), rows.data_ptr(), rowmap.data_ptr(), None,
                ops["x"].data_ptr(), ops["x"].stride(0), ops["dt"].data_ptr(),
                ops["A"].data_ptr(), ops["B"].data_ptr(), ops["B"].stride(0),
                ops["C"].data_ptr(), ops["C"].stride(0),
                ops["out"].data_ptr(), y.data_ptr(), Bp, H, P, N, 1, stream)
        nb, by = bound(2 * Bp * H * P * N * 4 + Bp * (H * P * 2 + 4 * N
                                                      + H * 4 + H * P * 4),
                       0)
        k_ms = time_ms(lambda: lib.ss_ssd_step(*bare))
        out_rows[f"rows_{Bp}"] = dict(
            shape=[Bp, H, P, N], pads=Bp - n, max_abs_err=0.0,
            y_rel_err=rel,
            ms=time_ms(lambda: ss_ops.ssd_step_rows(**ops)),
            ms_least=time_ms_least(lambda: ss_ops.ssd_step_rows(**ops)),
            kernel_only_ms=k_ms,
            plain_ms=time_ms(lambda: ss_ref.ssd_step_rows(
                **{**ops, "out": want_out})),
            bound_ms=nb, bound_by=by, bound_share=nb / k_ms,
            library_ms=None)
        del ops, want_out, y, want_y, xbc
    row = dict(out_rows["rows_64"])
    row["rows_8"] = out_rows["rows_8"]
    del arena
    return {"ssd_step": row}


def state_pair_rows(dev, gen, L, R) -> dict:
    """The state fork's copy as the flush runs it: the conv (rows of 3 x
    4352 bf16, 26 KB) and SSD (64 x 64 x 128 f32, 2 MiB) arenas of
    mamba2-1.3b, ``L`` layers of ``R`` rows, in one launch of
    ``page_copy_batched``.  Bit for bit against the plain version on 1
    and 8 disjoint rows (forks; the direct route) and a chain of 8 (the
    staged route: two 2 MiB rows overflow a cluster) before it is timed:
    the wrapper, the bare launch, and the two one-arena calls a flush
    made before."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rowclone import ref as rc_ref
    from repro_torch.kernels.ssm_scan import ops as ss_ops

    conv = torch.randn((L, 1, R, 3, 4352), generator=gen, device=dev,
                       dtype=torch.bfloat16)
    ssm = torch.randn((L, 1, R, 64, 64, 128), generator=gen, device=dev,
                      dtype=torch.float32)
    lib = _build.load("rowclone")
    stream = torch.cuda.current_stream(dev).cuda_stream
    row_bytes = (3 * 4352 * 2, 64 * 64 * 128 * 4)
    cases = {1: ([0], [R - 1]), 8: (list(range(8)), list(range(R - 8, R))),
             "chain": (list(range(8)), list(range(1, 9)))}
    for n, (src, dst) in cases.items():
        want = [rc_ref.page_copy_batched(a.clone().view(L, R, -1),
                                         torch.tensor(src), torch.tensor(dst))
                for a in (conv, ssm)]
        got = [conv.clone(), ssm.clone()]
        ss_ops.pim_state_copy_pair(*got, src, dst)
        torch.cuda.synchronize()
        if not all(same_bits(g.view(L, R, -1), w)
                   for g, w in zip(got, want)):
            raise AssertionError(f"page_copy_batched (state pair, {n}) "
                                 "disagrees with its plain version")
        del want, got
    out = {}
    flat = (conv.view(L, R, -1), ssm.view(L, R, -1))
    for n in (1, 8):
        src, dst = cases[n]
        bare, route = bare_copy(flat, 2, src, dst, stream)
        out[f"state_copy_pair_{n}_rows"] = dict(
            route=route,
            ms=time_ms(lambda: ss_ops.pim_state_copy_pair(conv, ssm, src,
                                                          dst)),
            kernel_only_ms=time_ms(lambda: lib.rc_copy_pages(*bare)),
            two_calls_ms=time_ms(lambda: (
                ss_ops.pim_state_copy(conv, src, dst),
                ss_ops.pim_state_copy(ssm, src, dst))),
            bound_ms=bound(2 * L * n * sum(row_bytes), 0)[0],
            bound_by="bytes")
    del conv, ssm, flat
    return out


def _tool(name: str):
    found = shutil.which(name)
    if found:
        return found
    cand = Path("/usr/local/cuda/bin") / name
    return str(cand) if cand.exists() else None


def _demangle(names):
    tool = _tool("c++filt")
    if not names or tool is None:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60)
    got = out.stdout.splitlines()
    return got if out.returncode == 0 and len(got) == len(names) \
        else list(names)


def ptxas_report(log: str) -> dict:
    """Registers, spill bytes and shared memory per kernel from ptxas's
    ``-v`` report."""
    kernels, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = kernels.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_store_bytes"] = int(m.group(1))
            cur["spill_load_bytes"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["static_smem_bytes"] = int(m.group(1))
    names = [re.sub(r"^void |\(.*", "",
                    n.replace("(anonymous namespace)::", ""))
             for n in _demangle(list(kernels))]
    return dict(zip(names, kernels.values()))


def attention_build_info() -> dict:
    """Phase 2: what ptxas reports for the two attention kernels, and the
    count of tensor-core instructions (HMMA, HGMMA) in each built
    library's SASS (``cuobjdump -sass``, where the toolkit has it).  The
    flash library must hold HMMA: its bf16 route runs on the tensor
    cores."""
    from repro_torch.kernels import _build

    out = {}
    for name in ("flash_attention", "paged_attention"):
        row = {"ptxas": ptxas_report(_build.build_log(name))}
        tool = _tool("cuobjdump")
        if tool is None:
            row["sass"] = "not measured (no cuobjdump)"
        else:
            sass = subprocess.run([tool, "-sass",
                                   str(_build.library_path(name))],
                                  capture_output=True, text=True,
                                  timeout=300).stdout
            row["sass"] = {op: sum(1 for ln in sass.splitlines()
                                   if f" {op}." in ln or f" {op} " in ln)
                           for op in ("HMMA", "HGMMA", "LDSM", "LDGSTS")}
        out[name] = row
    sass = out["flash_attention"]["sass"]
    if isinstance(sass, dict) and sass["HMMA"] + sass["HGMMA"] == 0:
        raise AssertionError("flash attention's library holds no "
                             "tensor-core instruction")
    spills = [k for row in out.values() for k, v in row["ptxas"].items()
              if v.get("spill_store_bytes", 0)]
    out["spilling_kernels"] = spills
    return out


def attention_heads_parity(dev, randn) -> dict:
    """The attention kernels at the hybrid shapes: jamba's 64 query
    heads over 8 KV heads (8 warps a group) and llama4-scout's 40 over 8
    (a group of 5, not a power of two), D = 128: paged decode attention
    with the current token merged, flash attention with ``lengths``, and
    its prefix-KV mode; each against its plain version at ATTN_TOL."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import ref as pa_ref

    P, S, KVH, D, B = 256, 16, 8, 128, 4
    out = {}
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(2))
    for H in (64, 40):
        k_ar, v_ar = randn(P, S, KVH, D), randn(P, S, KVH, D)
        lens_l = [1, 517, 1000, 233]
        need = [-(-n // S) for n in lens_l]
        width = 1 << (max(need) - 1).bit_length()
        bt = torch.zeros((B, width), dtype=torch.int32)
        at = 0
        for b, n in enumerate(need):
            bt[b, :n] = perm[at:at + n]
            at += n
        bt = bt.to(dev)
        lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        q = randn(B, H, D)
        kw = dict(k_self=randn(B, KVH, D), v_self=randn(B, KVH, D))
        row = {}
        got = pa_ops.paged_attention(q, k_ar, v_ar, bt, lens, **kw)
        want = pa_ref.paged_attention(q, k_ar, v_ar, bt, lens, **kw)
        torch.cuda.synchronize()
        row["paged_attention"] = float((got.float() - want.float()).abs()
                                       .max())
        torch.testing.assert_close(got.float(), want.float(), atol=ATTN_TOL,
                                   rtol=ATTN_TOL)
        row["paged_attention_ms"] = time_ms(
            lambda: pa_ops.paged_attention(q, k_ar, v_ar, bt, lens, **kw))
        Sf = 512
        qf = randn(2, H, Sf, D)
        kf, vf = randn(2, KVH, Sf, D), randn(2, KVH, Sf, D)
        flens = torch.tensor([512, 300], dtype=torch.int32, device=dev)
        got = fa_ops.attention(qf, kf, vf, causal=True, lengths=flens)
        want = fa_ref.attention(qf, kf, vf, causal=True, lengths=flens)
        torch.cuda.synchronize()
        row["flash_attention"] = float((got.float() - want.float()).abs()
                                       .max())
        torch.testing.assert_close(got.float(), want.float(), atol=ATTN_TOL,
                                   rtol=ATTN_TOL)
        kp = k_ar[bt[:2, :32].long()].view(2, 32 * S, KVH, D).transpose(1, 2)
        vp = v_ar[bt[:2, :32].long()].view(2, 32 * S, KVH, D).transpose(1, 2)
        pkw = dict(causal=True, lengths=torch.tensor(
            [256, 100], dtype=torch.int32, device=dev), k_prefix=kp,
            v_prefix=vp, prefix_lengths=torch.tensor(
                [1, 500], dtype=torch.int32, device=dev))
        qc, kc, vc = qf[:, :, :256], kf[:, :, :256], vf[:, :, :256]
        got = fa_ops.attention(qc, kc, vc, **pkw)
        want = fa_ref.attention(qc, kc, vc, **pkw)
        torch.cuda.synchronize()
        row["flash_attention_prefix"] = float((got.float() - want.float())
                                              .abs().max())
        torch.testing.assert_close(got.float(), want.float(), atol=ATTN_TOL,
                                   rtol=ATTN_TOL)
        out[f"heads_{H}_over_{KVH}"] = row
        del k_ar, v_ar, qf, kf, vf, kp, vp
    return {"max_abs_err": out, "atol": ATTN_TOL}


def rank_shapes_parity(dev, randn) -> dict:
    """Rows 1, 4, 5 and 5p at the shapes one rank of minitron-8b's
    two-rank tensor-parallel serving gives them (phase 20(b)): 16 query
    heads over 4 KV heads of 128, so K/V rows of 512 elements; the
    ``kv_scatter`` pair on a (32, 512, 16, 4, 128) arena pair bit for
    bit, the attention kernels at ATTN_TOL; each timed beside its plain
    version and bound."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import ref as pa_ref
    from repro_torch.kernels.rowclone import ops as rc_ops
    from repro_torch.kernels.rowclone import ref as rc_ref

    L, P, S, KVH, H, D, B = 32, 512, 16, 4, 16, 128, 4
    E = KVH * D
    out = {"heads": H, "kv_heads": KVH, "row_elems": E}
    k_ar, v_ar = randn(L, P, S, KVH, D), randn(L, P, S, KVH, D)
    k_new, v_new = randn(L, B, KVH, D), randn(L, B, KVH, D)
    pages = torch.tensor([3, 100, 257, 511], dtype=torch.int32, device=dev)
    slots = torch.tensor([0, 7, 15, 9], dtype=torch.int32, device=dev)
    want_k = k_ar.clone().view(L, P, S, E)
    want_v = v_ar.clone().view(L, P, S, E)
    rc_ref.kv_scatter_pair(want_k, want_v, pages, slots,
                           k_new.view(L, B, E), v_new.view(L, B, E))
    got_k, got_v = k_ar.clone(), v_ar.clone()
    rc_ops.kv_scatter_pair_inline(got_k, got_v, pages, slots, k_new, v_new)
    torch.cuda.synchronize()
    if not (same_bits(got_k.view(L, P, S, E), want_k)
            and same_bits(got_v.view(L, P, S, E), want_v)):
        raise AssertionError("kv_scatter at the per-rank shape disagrees "
                             "with its plain version")
    del want_k, want_v
    nb, by = bound(2 * L * B * E * 2 * 2 + 2 * B * 4, 0)
    out["kv_scatter"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: rc_ops.kv_scatter_pair_inline(
            got_k, got_v, pages, slots, k_new, v_new)),
        plain_ms=time_ms(lambda: rc_ref.kv_scatter_pair(
            got_k.view(L, P, S, E), got_v.view(L, P, S, E), pages, slots,
            k_new.view(L, B, E), v_new.view(L, B, E))),
        bound_ms=nb, bound_by=by)
    del got_k, got_v
    # paged decode attention over one layer, the token merged in-kernel
    lens_l = [1, 517, 1000, 233]
    need = [-(-n // S) for n in lens_l]
    width = 1 << (max(need) - 1).bit_length()
    bt = torch.zeros((B, width), dtype=torch.int32)
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(3))
    at = 0
    for b, n in enumerate(need):
        bt[b, :n] = perm[at:at + n]
        at += n
    bt = bt.to(dev)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    k_l, v_l = k_ar[0], v_ar[0]
    q = randn(B, H, D)
    kw = dict(k_self=randn(B, KVH, D), v_self=randn(B, KVH, D))
    got = pa_ops.paged_attention(q, k_l, v_l, bt, lens, **kw)
    want = pa_ref.paged_attention(q, k_l, v_l, bt, lens, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=ATTN_TOL,
                               rtol=ATTN_TOL)
    kv_bytes = sum(lens_l) * 2 * E * 2
    nb, by = bound(kv_bytes + 2 * B * H * D * 2,
                   4 * sum(lens_l) * H * D)
    out["paged_attention"] = dict(
        max_abs_err=float((got.float() - want.float()).abs().max()),
        ms=time_ms(lambda: pa_ops.paged_attention(q, k_l, v_l, bt, lens,
                                                  **kw)),
        plain_ms=time_ms(lambda: pa_ref.paged_attention(q, k_l, v_l, bt,
                                                        lens, **kw)),
        bound_ms=nb, bound_by=by)
    # flash attention with lengths, and its prefix-KV mode
    Sf = 512
    qf = randn(2, H, Sf, D)
    kf, vf = randn(2, KVH, Sf, D), randn(2, KVH, Sf, D)
    flens = torch.tensor([512, 300], dtype=torch.int32, device=dev)
    got = fa_ops.attention(qf, kf, vf, causal=True, lengths=flens)
    want = fa_ref.attention(qf, kf, vf, causal=True, lengths=flens)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=ATTN_TOL,
                               rtol=ATTN_TOL)
    causal_pairs = (512 * 513 + 300 * 301) // 2
    nb, by = bound(2 * (2 * H + 2 * KVH) * Sf * D * 2,
                   4 * causal_pairs * H * D)
    out["flash_attention"] = dict(
        max_abs_err=float((got.float() - want.float()).abs().max()),
        ms=time_ms(lambda: fa_ops.attention(qf, kf, vf, causal=True,
                                            lengths=flens)),
        plain_ms=time_ms(lambda: fa_ref.attention(qf, kf, vf, causal=True,
                                                  lengths=flens)),
        bound_ms=nb, bound_by=by)
    kp = k_l[bt[:2, :32].long()].view(2, 32 * S, KVH, D).transpose(1, 2)
    vp = v_l[bt[:2, :32].long()].view(2, 32 * S, KVH, D).transpose(1, 2)
    plens = [1, 500]
    pkw = dict(causal=True, lengths=torch.tensor(
        [256, 100], dtype=torch.int32, device=dev), k_prefix=kp,
        v_prefix=vp, prefix_lengths=torch.tensor(
            plens, dtype=torch.int32, device=dev))
    qc, kc, vc = qf[:, :, :256], kf[:, :, :256], vf[:, :, :256]
    got = fa_ops.attention(qc, kc, vc, **pkw)
    want = fa_ref.attention(qc, kc, vc, **pkw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=ATTN_TOL,
                               rtol=ATTN_TOL)
    pairs = (256 * 257 + 100 * 101) // 2 + 256 * plens[0] + 100 * plens[1]
    # q and out, the chunk's K and V, and only the valid prefix's K and V
    nb, by = bound((2 * 2 * 256 * H + 2 * 2 * 256 * KVH + 2 * sum(plens) * KVH)
                   * D * 2 + 2 * 2 * 4, 4 * pairs * H * D)
    out["flash_attention_prefix"] = dict(
        max_abs_err=float((got.float() - want.float()).abs().max()),
        ms=time_ms(lambda: fa_ops.attention(qc, kc, vc, **pkw)),
        plain_ms=time_ms(lambda: fa_ref.attention(qc, kc, vc, **pkw)),
        bound_ms=nb, bound_by=by)
    out["atol"] = ATTN_TOL
    return out


def rowclone_api_parity(dev, shape=(40, 1024, 16, 8, 128)) -> dict:
    """Phase 2, the RowClone API's kernels bit for bit against their
    plain versions: ``copy_2d`` and ``init_2d`` on granite-3-8b's full K
    arena (40, 1024, 16, 8, 128) bf16, ``init_2d`` also at an odd bf16
    length and in int8; ``page_copy`` and ``page_init`` on one layer of
    it, (1024, 16384) bf16, 16 pages, with a batch whose destination is
    another op's source and a duplicate destination (the last op
    wins)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rowclone import ops as rc_ops
    from repro_torch.kernels.rowclone import ref as rc_ref

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(5)
    arena = torch.randn(shape, generator=gen, device=dev, dtype=bf16)
    nbytes = arena.numel() * 2
    rows = {}

    got = rc_ops.pim_copy(arena)
    torch.cuda.synchronize()
    if not same_bits(got, rc_ref.copy_2d(arena)):
        raise AssertionError("copy_2d disagrees with its plain version")
    del got
    nb, by = bound(2 * nbytes, 0)
    rows["copy_2d"] = dict(
        max_abs_err=0.0, ms=time_ms(lambda: rc_ops.pim_copy(arena)),
        plain_ms=time_ms(lambda: rc_ref.copy_2d(arena)),
        bound_ms=nb, bound_by=by, library_ms=time_ms(arena.clone))

    for shp, value, dt in ((shape, 0.1, bf16), ((1_000_003,), 0.1, bf16),
                           (shape, -3, torch.int8), ((3, 333_333), 7,
                                                     torch.int8)):
        got = rc_ops.pim_init(shp, value, dt, device=dev)
        torch.cuda.synchronize()
        if not same_bits(got, rc_ref.init_2d(shp, value, dt, dev)):
            raise AssertionError(f"init_2d {shp} {dt} disagrees with its "
                                 "plain version")
        del got
    nb, by = bound(nbytes, 0)
    rows["init_2d"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: rc_ops.pim_init(shape, 0.0, bf16, device=dev)),
        plain_ms=time_ms(lambda: rc_ref.init_2d(shape, 0.0, bf16, dev)),
        bound_ms=nb, bound_by=by,
        library_ms=time_ms(lambda: torch.zeros(shape, dtype=bf16,
                                               device=dev)))

    layer = arena[0].reshape(shape[1], -1).clone()
    del arena
    page_bytes = layer.shape[1] * 2
    # 16 ops: op 14 repeats op 13's destination (the last wins), op 15
    # writes the page op 0 reads (staged through scratch); then a
    # disjoint batch, the common case, which is the timed one
    staged = (list(range(100, 116)), list(range(200, 214)) + [213, 100])
    disjoint = (list(range(300, 316)), list(range(400, 416)))
    for src, dst in (staged, disjoint):
        want = rc_ref.page_copy(layer.clone(), torch.tensor(src, device=dev),
                                torch.tensor(dst, device=dev))
        got = rc_ops.pim_page_copy(layer.clone(), src, dst)
        torch.cuda.synchronize()
        if not same_bits(got, want):
            raise AssertionError(f"page_copy disagrees with its plain "
                                 f"version on {src} -> {dst}")
    del want, got
    src, dst = disjoint
    work = layer.clone()
    src_t = torch.tensor(src, device=dev)
    dst_t = torch.tensor(dst, device=dev)
    nb, by = bound(2 * len(src) * page_bytes, 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc_lib = _build.load("rowclone")
    bare, _ = bare_copy((work,), 1, src, dst, stream)
    # the overlapping batch as the kernel gets it: the duplicate dropped
    keep = rc_ref.last_op_per_dst(staged[1])
    o_src = [staged[0][i] for i in keep]
    o_dst = [staged[1][i] for i in keep]
    bare_o, route_o = bare_copy((work,), 1, o_src, o_dst, stream)
    rows["page_copy"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: rc_ops.pim_page_copy(work, src, dst)),
        kernel_only_ms=time_ms(lambda: rc_lib.rc_copy_pages(*bare)),
        plain_ms=time_ms(lambda: rc_ref.page_copy(work, src_t, dst_t)),
        bound_ms=nb, bound_by=by, library_ms=None,
        two_calls_library_ms=time_ms(
            lambda: work.index_copy_(0, dst_t, work.index_select(0, src_t))),
        overlapping_route=route_o,
        overlapping_ms=time_ms(
            lambda: rc_ops.pim_page_copy(work, *staged)),
        overlapping_kernel_only_ms=time_ms(
            lambda: rc_lib.rc_copy_pages(*bare_o)))
    for pages, value in ((dst, 0.1), (staged[1], 0.0)):
        want = rc_ref.page_init(layer.clone(), torch.tensor(pages,
                                                            device=dev),
                                value)
        got = rc_ops.pim_page_init(layer.clone(), pages, value)
        torch.cuda.synchronize()
        if not same_bits(got, want):
            raise AssertionError(f"page_init disagrees with its plain "
                                 f"version at {value}")
    del want, got
    nb, by = bound(len(dst) * page_bytes, 0)
    dst_host = np.asarray(dst, np.int32)
    bare = (work.data_ptr(), work.data_ptr(), 1, None, dst_host.ctypes.data,
            layer.shape[0], len(dst), 1, page_bytes, 0, stream)
    rows["page_init"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: rc_ops.pim_page_init(work, dst, 0.0)),
        kernel_only_ms=time_ms(lambda: rc_lib.rc_init_rows(*bare)),
        plain_ms=time_ms(lambda: rc_ref.page_init(work, dst_t, 0.0)),
        bound_ms=nb, bound_by=by,
        library_ms=time_ms(lambda: work.index_fill_(0, dst_t, 0.0)))
    del work, layer
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------- #
# Phase 13: RowClone against memcpy and calloc on the card
# ---------------------------------------------------------------------- #


SWEEP_BYTES = (8 << 10, 64 << 10, 512 << 10, 4 << 20, 32 << 20, 256 << 20,
               1 << 30)


def rowclone_sweep(dev, sizes=SWEEP_BYTES, arena=(40, 1024, 16 * 8 * 128)
                   ) -> tuple:
    """The RowClone API as a user calls it, against the PyTorch calls it
    stands for: ``pim_copy`` against ``Tensor.clone()`` and
    ``pim_init(..., 0)`` against ``torch.zeros`` at 8 KiB to 1 GiB of
    bf16, each with its share of the card's memory rate (3.35 TB/s; a
    copy moves twice its bytes); then granite-3-8b's 40 layers of
    16-page copies and inits looped (40 launches of ``page_copy`` /
    ``page_init``, one a layer) against batched (one launch of
    ``page_copy_batched`` / ``page_init_batched``), the results bit for
    bit equal.  The kernel launch counts are zeroed just before and read
    just after."""
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.kernels.rowclone import ops as rc_ops

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(6)
    lines = []
    reset_launches()
    for nb in sizes:
        n = nb // 2
        src = torch.randn((n,), generator=gen, device=dev, dtype=bf16)
        if not same_bits(rc_ops.pim_copy(src), src):
            raise AssertionError(f"pim_copy at {nb} bytes is not a copy")
        if torch.count_nonzero(rc_ops.pim_init((n,), 0, bf16,
                                               device=dev)):
            raise AssertionError(f"pim_init at {nb} bytes is not zero")
        iters = 50 if nb <= (32 << 20) else 20
        t = {"pim_copy": time_ms(lambda: rc_ops.pim_copy(src), iters),
             "clone": time_ms(src.clone, iters),
             "pim_init": time_ms(lambda: rc_ops.pim_init(
                 (n,), 0, bf16, device=dev), iters),
             "zeros": time_ms(lambda: torch.zeros((n,), dtype=bf16,
                                                  device=dev), iters)}
        moved = {"pim_copy": 2 * nb, "clone": 2 * nb, "pim_init": nb,
                 "zeros": nb}
        lines.append({"bytes": nb, "ms": t, "memory_rate_share": {
            k: moved[k] / (t[k] * 1e-3) / HBM_BYTES_PER_S for k in t},
            # rows 11-12 against the library call (< 1: the kernel wins)
            "copy_over_clone": t["pim_copy"] / t["clone"],
            "init_over_zeros": t["pim_init"] / t["zeros"]})
        del src

    L, P, E = arena
    arena = torch.randn((L, P, E), generator=gen, device=dev, dtype=bf16)
    src, dst = list(range(100, 116)), list(range(200, 216))

    def looped_copy(a):
        for l in range(L):
            rc_ops.pim_page_copy(a[l], src, dst)
        return a

    def looped_init(a):
        for l in range(L):
            rc_ops.pim_page_init(a[l], dst, 0.0)
        return a

    a, b = looped_copy(arena.clone()), \
        rc_ops.pim_page_copy_batched(arena.clone(), src, dst)
    a, b = looped_init(a), rc_ops.pim_page_init_batched(b, dst, 0.0)
    torch.cuda.synchronize()
    if not same_bits(a, b):
        raise AssertionError("looped and batched page ops disagree")
    del a, b
    page_bytes = E * 2
    layered = {
        "copy_looped_ms": time_ms(lambda: looped_copy(arena)),
        "copy_batched_ms": time_ms(
            lambda: rc_ops.pim_page_copy_batched(arena, src, dst)),
        "init_looped_ms": time_ms(lambda: looped_init(arena)),
        "init_batched_ms": time_ms(
            lambda: rc_ops.pim_page_init_batched(arena, dst, 0.0)),
        "copy_bound_ms": bound(2 * L * len(src) * page_bytes, 0)[0],
        "init_bound_ms": bound(L * len(dst) * page_bytes, 0)[0]}
    counts = launch_counts()
    missing = [k for k in SWEEP_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the path: {missing}")
    del arena
    torch.cuda.empty_cache()
    slower = {k: [ln["bytes"] for ln in lines
                  if ln["bytes"] >= (1 << 20) and ln[k] > 1.0]
              for k in ("copy_over_clone", "init_over_zeros")}
    return ({"phase": "rowclone_vs_memcpy", "dtype": "bfloat16",
             "sizes": lines, "slower_than_library_at_1MiB_up": slower,
             "layers": L, "pages": len(src),
             "page_bytes": page_bytes, **layered,
             "kernel_launches": _nonzero(counts)}, counts)


# ---------------------------------------------------------------------- #
# Phase 14: trace recording and replay on the simulated DDR3 prototype
# ---------------------------------------------------------------------- #


MODEL_FACE = ("simulated DDR3 prototype (PiDRAM's model face): latencies "
              "in the prototype's nanoseconds, not times of the card")


def _traced_serve(cfg, params, dev):
    """Phase 3's workload (8 greedy requests, monolithic, no EOS, the
    prefix cache off) with ``record_trace=True``, a CoW fork of a live
    sequence after the first round and its free after the second."""
    from repro_torch.launch.serve import serve
    from repro_torch.serving.engine import Request

    forked = {}

    def between_rounds(engine, i):
        if i == 1:
            for rid in sorted(engine.active):
                if engine.cache.seqs[rid].length % engine.cache.page_size:
                    engine.cache.fork(rid, 1000)
                    forked["from"] = rid
                    break
        elif i == 2 and forked:
            engine.cache.free(1000)

    out = serve(cfg, params, granite_requests(cfg, Request), page_size=16,
                num_pages=1024, device=dev, between_rounds=between_rounds,
                record_trace=True)
    if not forked:
        raise AssertionError("no live sequence with a partial tail to fork")
    engine = out["engine"]
    if engine.cache.pages_in_use != 0:
        raise AssertionError(f"{engine.cache.pages_in_use} pages leaked")
    check_streams(cfg, out["results"], 8)
    return engine


def _event_counts(trace) -> dict:
    out = {}
    for e in trace.events:
        out[e.kind] = out.get(e.kind, 0) + 1
    return out


def trace_replay(dev, cfg, params, small=None) -> dict:
    """granite-3-8b at full width and depth serves phase 3's workload
    with ``record_trace=True``; every queue kind's events must equal its
    flushes (one launch per arena, k and v), the fused steps' KV events
    their launches, and the two pairwise prefix hits their events.  The
    trace is replayed on the simulated DDR3 prototype (host time
    measured).  Then the same workload at 2 layers on the card and on
    the CPU (the plain versions), from identical weights: the two traces
    must be equal event for event (with no EOS and no prefix cache every
    page decision depends on lengths only) and their replays equal in
    every total."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params, tree_map
    from repro_torch.serving.trace import replay_on_device

    t0 = time.perf_counter()
    engine = _traced_serve(cfg, params, dev)
    serve_s = time.perf_counter() - t0
    trace, q = engine.cache.trace, engine.cache.queue
    events = _event_counts(trace)
    launches = q.launches_by_kind
    flushes = {k: launches.get(k, 0) // 2 for k in ("page_copy",
                                                     "page_init")}
    for kind, n in flushes.items():
        if events.get(kind, 0) != n:
            raise AssertionError(f"{kind}: {events.get(kind, 0)} trace "
                                 f"events for {n} flushes")
    fused = launches.get("fused_prefill", 0) + launches.get("fused_decode",
                                                            0)
    if events.get("kv_write", 0) != fused:
        raise AssertionError(f"kv_write: {events.get('kv_write', 0)} events "
                             f"for {fused} fused launches")
    if events.get("prefix_hit", 0) != engine.cache.stats["prefix_hits"]:
        raise AssertionError("prefix hits and their events differ")
    t0 = time.perf_counter()
    rep = replay_on_device(trace)
    replay_s = time.perf_counter() - t0
    if not all(r.ok for r in rep["receipts"]):
        raise AssertionError("a replayed op failed on the prototype")
    if not rep["pim_ns"]["total"] < rep["cpu_ns"]["total"]:
        raise AssertionError("replay: PiM total not below the CPU total")
    full = {"layers": cfg.num_layers, "num_pages": trace.num_pages,
            "num_slabs": trace.num_slabs, "events": events,
            "ops": rep["counts"], "queue_flushes": flushes,
            "fused_kv_launches": fused, "serve_seconds": serve_s,
            "replay_host_seconds": replay_s,
            "simulated_pim_ns": rep["pim_ns"],
            "simulated_cpu_ns": rep["cpu_ns"],
            "simulated_speedup": rep["speedup"],
            "simulated_device_stats": rep["device_stats"]}
    del engine

    if small is None:
        small = dataclasses.replace(ARCHS["granite-3-8b"], num_layers=2)
    gen = torch.Generator(device=dev).manual_seed(2)
    p_gpu = init_params(T.model_defs(small), gen, dev, torch.bfloat16)
    p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
    traces, seconds = {}, {}
    for name, p, d in (("gpu", p_gpu, dev), ("cpu", p_cpu, "cpu")):
        t0 = time.perf_counter()
        traces[name] = _traced_serve(small, p, d).cache.trace
        seconds[name] = time.perf_counter() - t0
    ev = {k: [dataclasses.astuple(e) for e in t.events]
          for k, t in traces.items()}
    if ev["gpu"] != ev["cpu"]:
        diff = next(i for i, (a, b) in enumerate(zip(ev["gpu"], ev["cpu"]))
                    if a != b) if len(ev["gpu"]) == len(ev["cpu"]) else -1
        raise AssertionError(f"card and CPU traces differ (event {diff}, "
                             f"{len(ev['gpu'])} vs {len(ev['cpu'])})")
    reps = {k: replay_on_device(t) for k, t in traces.items()}
    for key in ("counts", "pim_ns", "cpu_ns", "speedup", "device_stats"):
        if reps["gpu"][key] != reps["cpu"][key]:
            raise AssertionError(f"card and CPU replays differ in {key}")
    del p_gpu, p_cpu
    return {"phase": "trace_replay", "model_face": MODEL_FACE, **full,
            "cross_check_2_layers": {
                "events": len(ev["gpu"]), "equal": True,
                "serve_seconds": seconds,
                "simulated_pim_total_ns": reps["gpu"]["pim_ns"]["total"],
                "simulated_cpu_total_ns": reps["gpu"]["cpu_ns"]["total"]}}


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

    cfg = ARCHS["granite-3-8b"]
    params, seconds = _model_params(dev, cfg, 0)
    return cfg, params, seconds


def check_streams(cfg, results, n, eos=None, new_tokens=32):
    """Every request finished with its ``new_tokens`` tokens (or stopped
    at its EOS) inside the vocabulary."""
    if sorted(results) != list(range(n)):
        raise AssertionError(f"finished requests {sorted(results)}")
    for rid, v in results.items():
        stop = eos.get(rid) if eos else None
        want = (new_tokens if stop is None or stop not in v
                else v.index(stop) + 1)
        if len(v) != want:
            raise AssertionError(f"request {rid}: {len(v)} tokens, "
                                 f"expected {want}")
        if not all(0 <= t < cfg.vocab_size for t in v):
            raise AssertionError(f"request {rid}: token outside the "
                                 "vocabulary")


def counted_fork(engine, rid) -> dict:
    """Fork ``rid`` into sequence 1000 (its flush runs inside ``fork``)
    and return the fork's copy launches (``page_copy_batched`` in
    :data:`LAUNCHES`) and the queue's deltas by kind."""
    from repro_torch.kernels import LAUNCHES

    q = engine.cache.queue
    before, launches = q.snapshot(), LAUNCHES["page_copy_batched"]
    engine.cache.fork(rid, 1000)
    return {"from": rid,
            "copy_launches": LAUNCHES["page_copy_batched"] - launches,
            "launches_by_kind": q.delta(before)}


def check_fork(forked, copies, what) -> None:
    """Each copy kind a fork flushes (the KV tail's ``page_copy``, the
    state row's ``state_copy``) is one launch of the page-copy kernel
    over its arena pair, while the queue counts ``copies`` (the JAX
    package's count: one per arena)."""
    got = {k: forked["launches_by_kind"].get(k, 0) for k in copies}
    if forked["copy_launches"] != len(copies) or got != copies:
        raise AssertionError(f"{what}: a fork's copy flush made "
                             f"{forked['copy_launches']} launches, the "
                             f"queue counted {got} (want {len(copies)} "
                             f"and {copies})")


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
                    forked.update(counted_fork(engine, rid))
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
    check_fork(forked, {"page_copy": 2}, "serve")
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
          **_graph_stats(engine),
          "first_round_ms": rs[0] * 1e3,
          "decode_round_ms": [x * 1e3 for x in rs[1:]],
          "decode_round_ms_median": float(np.median(rs[1:])) * 1e3,
          "tokens": out["tokens"], "seconds": out["seconds"],
          "tokens_per_s": out["tokens"] / out["seconds"],
          "weight_stream_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
          "launches_by_kind": _nonzero(engine.cache.queue.launches_by_kind),
          "kernel_launches": counts,
          "forked_from": forked["from"], "fork_flush": forked,
          "pages_in_use": engine.cache.pages_in_use,
          "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
          "streams_head": {k: v[:8] for k, v in sorted(results.items())}})
    return counts, results, float(np.median(rs[1:])) * 1e3


def _round_kind(delta) -> str:
    """What a step ran, from its launches_by_kind delta."""
    if delta.get("fused_mixed"):
        return "mixed"
    if delta.get("fused_decode_block"):
        return "decode_block"
    if delta.get("fused_prefill"):
        return "chunk+decode" if delta.get("fused_decode") else "chunk"
    return "decode"


def _steps(out) -> dict:
    """A ``serve`` run's steps by kind: counts, host-clock medians and
    every step's ms."""
    ms = {}
    for d, sec in zip(out["round_launches"], out["round_seconds"]):
        ms.setdefault(_round_kind(d), []).append(sec * 1e3)
    return {"steps": len(out["round_seconds"]),
            "step_kinds": {k: len(v) for k, v in ms.items()},
            "step_ms_median": {k: float(np.median(v)) for k, v in ms.items()},
            "step_ms": ms}


class _FirstTokens:
    """Each request's time to first token on the host clock, from its
    submission to the end of the step that gave its first token."""

    def __init__(self) -> None:
        self.start: dict = {}
        self.ms: dict = {}

    def submitted(self, reqs) -> None:
        now = time.perf_counter()
        for r in reqs:
            self.start[r.req_id] = (now, r)

    def step_done(self) -> None:
        now = time.perf_counter()
        for rid, (t, r) in self.start.items():
            if rid not in self.ms and (r.out_tokens or r.done):
                self.ms[rid] = (now - t) * 1e3

    def summary(self) -> dict:
        if len(self.ms) != len(self.start):
            raise AssertionError(f"first tokens of {sorted(self.ms)} of "
                                 f"{sorted(self.start)}")
        v = list(self.ms.values())
        return {"ttft_p50_ms": float(np.percentile(v, 50)),
                "ttft_p99_ms": float(np.percentile(v, 99))}


def _chunked_serve(dev, cfg, params, eos_token, cuda_graphs=True,
                   uses=None, first=None):
    """Phase 4's workload through ``serve``: chunked prefill (256-token
    chunks), mixed rounds and 8-round decode blocks; requests 0-3 first,
    4-7 after step 2; even ids greedy, odd ids sampled at temperature
    1.0; request 2 stops at ``eos_token``.  ``uses`` (a list) gets the
    engine's step-cache misses and graphs so far after each step;
    ``first`` (a :class:`_FirstTokens`) the requests' first tokens."""
    from repro_torch.launch.serve import serve
    from repro_torch.serving.engine import Request

    reqs = granite_requests(cfg, Request,
                            temperature=lambda i: float(i % 2))
    reqs[2].eos_token_id = eos_token
    late = reqs[4:]

    def between_rounds(engine, i):
        if first is not None:
            first.step_done()
        if uses is not None:
            uses.append((sum(engine.stats[k] for k in TRACE_KEYS),
                         engine._steps.captured))
        if i == 1:
            for r in late:
                engine.submit(r)
            if first is not None:
                first.submitted(late)

    return serve(cfg, params, reqs[:4], page_size=16, num_pages=1024,
                 device=dev, between_rounds=between_rounds,
                 setup=None if first is None else
                 (lambda e: first.submitted(reqs[:4])),
                 max_prefill_chunk=256, mixed_rounds=True,
                 decode_block_rounds=8, cuda_graphs=cuda_graphs)


def serving_chunked(dev, cfg, params, greedy_streams) -> dict:
    """Phase 4: :func:`_chunked_serve` with request 2's EOS taken from
    its phase-3 greedy stream."""
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.serving.engine import Request

    reqs = granite_requests(cfg, Request,
                            temperature=lambda i: float(i % 2))
    eos = {2: greedy_streams[2][8]}
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    out = _chunked_serve(dev, cfg, params, eos[2])
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
    agree = {rid: next((i for i, (a, b) in enumerate(
        zip(results[rid], greedy_streams[rid])) if a != b),
        min(len(results[rid]), 32)) for rid in (0, 2, 4, 6)}
    emit({"phase": "serve_chunked", "arch": cfg.name,
          "layers": cfg.num_layers, "max_prefill_chunk": 256,
          "decode_block_rounds": 8,
          "temperatures": [r.temperature for r in reqs],
          "eos": eos, "eos_fired": eos[2] in results[2],
          "tokens": out["tokens"], "seconds": out["seconds"],
          "tokens_per_s": out["tokens"] / out["seconds"], **_steps(out),
          "launches_by_kind": _nonzero(by_kind),
          "kernel_launches": counts,
          "stats": {k: engine.stats[k] for k in (
              "prefill_chunks", "mixed_dispatches", "multi_round_blocks",
              "decode_rounds", "fused_prefill_dispatches",
              "decode_stall_rounds")},
          "rng_ctr": engine.rng_ctr, **_graph_stats(engine),
          "pages_in_use": engine.cache.pages_in_use,
          "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
          # greedy rows: tokens before the first difference from phase 3
          "greedy_prefix_agreement": agree,
          "streams_head": {k: v[:8] for k, v in sorted(results.items())}})
    return counts


def trace(dev, cfg, params) -> dict:
    """``torch.profiler`` over the phase-4 workload on a fresh engine:
    the card's busy time (the sum of its kernel and copy times; one
    stream, so they do not overlap) in the first chunk step, mixed round
    and decode block that only replay graphs captured before them (no
    step-cache miss and no capture in the step), by kernel group, beside the step's host-clock time under the
    profiler (which slows the host); each window's kernels held equal to
    its counted launches (:func:`_ran_as_counted`)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import launch_counts
    from repro_torch.serving.engine import PagedEngine, Request

    engine = PagedEngine(cfg, params, page_size=16, num_pages=1024,
                         device=dev, max_prefill_chunk=256,
                         decode_block_rounds=8)
    reqs = granite_requests(cfg, Request, temperature=lambda i: float(i % 2))
    for r in reqs[:4]:
        engine.submit(r)
    queue = engine.cache.queue
    kinds = ("chunk", "mixed", "decode_block")
    out = {}
    steps = 0
    while engine.has_work and len(out) < len(kinds):
        rounds = (engine.decode_block_rounds
                  if engine.prefill_backlog_tokens() == 0 else 1)
        before = queue.snapshot()
        misses = {k: engine.stats[k] for k in TRACE_KEYS}
        graphs = engine._steps.captured
        torch.cuda.synchronize(dev)
        counted = launch_counts()
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
        # replays only: no key met first and no graph captured in it
        replayed = (all(engine.stats[k] == misses[k] for k in TRACE_KEYS)
                    and engine._steps.captured == graphs)
        if kind not in kinds or kind in out or not replayed:
            continue
        out[kind] = {"profiled_step_ms": wall_ms, "replayed": True,
                     **_device_busy(prof), **_ran_as_counted(prof, counted)}
    if set(out) != set(kinds):
        raise AssertionError(f"the traced run replayed only {sorted(out)}")
    del engine
    # a decode round and a block of phase 3's greedy workload, each a
    # replay of its captured graph
    out.update(_profile_replays(dev, cfg, params, granite_requests(
        cfg, Request), num_pages=1024))
    return {"phase": "trace", "layers": cfg.num_layers, **out}


# the CUDA API calls (runtime ``cuda*`` and low-level ``cu*``) by which
# the host puts work on the card: kernel and graph launches, copies, fills
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                     "cudaMemcpyAsync", "cudaMemsetAsync")


def _device_busy(prof) -> dict:
    """The card's busy time in a profiled window, by kernel group, the
    device events (kernels and copies) it ran and the host's calls that
    put work on it."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = {}
    for e in kernels:
        group = _kernel_group(e.key)
        busy[group] = busy.get(group, 0.0) + e.self_device_time_total / 1e3
    total = sum(busy.values())
    host = {e.key: e.count for e in events
            if e.device_type == DeviceType.CPU and e.key in HOST_LAUNCH_CALLS}
    return {"device_busy_ms": total if total else "not measured",
            "busy_ms_by_group": dict(sorted(busy.items(),
                                            key=lambda kv: -kv[1])),
            "kernel_launches": sum(e.count for e in kernels),
            "host_launch_calls": host}


def trace_ssm(dev) -> dict:
    """``torch.profiler`` over mamba2-1.3b at full width and depth: a
    replayed decode round and a replayed 8-round decode block of 8
    greedy requests (phase 10's prompts) on a 128-row state arena (see
    :func:`_profile_replays`)."""
    from repro_torch.configs import ARCHS
    from repro_torch.serving.engine import Request

    cfg = ARCHS["mamba2-1.3b"]
    params, _ = _model_params(dev, cfg, 10)
    out = _profile_replays(dev, cfg, params, seeded_requests(
        cfg, Request, 8, 97, 450, 32), num_pages=128)
    del params
    _free_card()
    return {"phase": "trace_ssm", "arch": cfg.name,
            "layers": cfg.num_layers, **out}


def _profile_replays(dev, cfg, params, reqs, num_pages) -> dict:
    """``torch.profiler`` over one decode round and one 8-round decode
    block of ``reqs`` (greedy), each only replays of a graph captured
    before it (a step that met its key first or captured its graph is
    run again, profiled, until a replay comes): the card's busy time by kernel group, the device
    events it ran and the host's calls that put them there, beside the
    host-clock step time under the profiler (which slows the host).
    The package's kernels the card ran are held equal to the launches
    counted in the window, the replays' recorded deltas included
    (:func:`_ran_as_counted`)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import launch_counts
    from repro_torch.serving.engine import PagedEngine

    out = {}
    for kind, K, stat in (("decode_captured", 1, "jit_traces"),
                          ("decode_block_captured", 8, "block_jit_traces")):
        engine = PagedEngine(cfg, params, page_size=16, num_pages=num_pages,
                             device=dev, decode_block_rounds=K)
        for r in reqs:
            engine.submit(dataclasses.replace(r, out_tokens=[], done=False))
        engine.run(max_rounds=1)                     # prefill
        for _ in range(8):
            misses = engine.stats[stat]
            graphs = engine._steps.captured
            torch.cuda.synchronize(dev)
            counted = launch_counts()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                engine.run(max_rounds=K)
                torch.cuda.synchronize(dev)
                wall_ms = (time.perf_counter() - t0) * 1e3
            if engine.stats[stat] == misses and graphs \
                    and engine._steps.captured == graphs:
                busy = _device_busy(prof)
                share = (busy["device_busy_ms"] / wall_ms
                         if wall_ms and busy["device_busy_ms"]
                         != "not measured" else "not measured")
                out[kind] = {"profiled_step_ms": wall_ms,
                             "device_busy_share": share, **busy,
                             **_ran_as_counted(prof, counted)}
                break
        else:
            raise AssertionError(f"{kind}: no replayed step in 8 tries")
        del engine
    return out


def _ran_as_counted(prof, before: dict) -> dict:
    """The package's kernels the card ran in a profiled window, by device
    kernel, held equal to the launches counted in it (``LAUNCHES`` now
    less ``before``: the wrappers' own counts and each replay's recorded
    capture delta); raises if they differ."""
    from torch.autograd import DeviceType
    from repro_torch.kernels import (LAUNCHES, device_kernel_counts,
                                     ran_on_device)

    counted = device_kernel_counts({k: LAUNCHES[k] - before[k]
                                    for k in LAUNCHES})
    ran = ran_on_device(e for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA)
    if ran != counted:
        raise AssertionError(f"the card ran {ran}, the launch counts say "
                             f"{counted}")
    return {"kernels_ran_as_counted": ran}


def _kernel_group(name: str) -> str:
    """A device event's group for the trace's breakdown."""
    n = name.lower()
    for key, group in (("flash_", "flash_attention"),
                       ("paged", "paged_attention"),
                       ("drange", "random_u32"),
                       ("state_scatter", "state_scatter"),
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


TRACE_KEYS = ("jit_traces", "block_jit_traces", "prefill_jit_traces",
              "mixed_jit_traces")


def _graph_stats(engine) -> dict:
    """An engine's step-cache misses by counter (the JAX engine's
    retrace names), the graphs it captured, the host seconds of the
    eager first uses and of the captures, and the reserved bytes its
    captures added (the graphs' shared pool)."""
    cache = engine._steps
    return {"traces": {k: engine.stats[k] for k in TRACE_KEYS},
            "graphs_captured": cache.captured,
            "first_use_seconds": cache.first_use_seconds,
            "capture_seconds": cache.capture_seconds,
            "graph_pool_gib": cache.pool_bytes / 2**30}


def _check_captured(engine, what) -> None:
    """A step is captured on its key's second use: the graphs are those
    of the keys met at least twice (two for a mixed key), none without
    capture."""
    cache = engine._steps
    if cache.captured != cache.due:
        raise AssertionError(f"{what}: {cache.captured} graphs for "
                             f"{cache.due} steps of keys met twice")


# ---------------------------------------------------------------------- #
# Phase 15: the decode and K-block rounds as captured CUDA graphs
# ---------------------------------------------------------------------- #


def graphs_ab(dev, cfg, params, make_requests, num_pages) -> dict:
    """One model's half of phase 15: phase 3's (or 10(a)'s) workload —
    greedy, monolithic, one round a step, a CoW fork of a live sequence
    after the first decode round and its free after the second — twice
    in this process, first with ``cuda_graphs=False`` (every kernel
    launched from Python), then with ``True`` (each prefill batch and
    decode round one replay of its bucket's graph, or its capture).
    Required: token-identical streams, identical ``launches_by_kind``
    deltas and kernel launch counts, 0 pages and state rows in use.
    Reported: both decode-round medians (host clock, each round ending
    in its token transfer and a synchronise), the prefill's host
    milliseconds, the requests' TTFT (all submitted at the start), the
    step-cache misses, the seconds of their eager first uses and of the
    captures, and the graphs' pool."""
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.serve import serve

    runs = {}
    for graphs in (False, True):
        first = _FirstTokens()
        reqs = make_requests()

        def between_rounds(engine, i):
            first.step_done()
            if i == 1:
                rid = next(r for r in sorted(engine.active)
                           if engine.cache.seqs[r].length
                           % engine.cache.page_size)
                engine.cache.fork(rid, 1000)
            elif i == 2:
                engine.cache.free(1000)

        reset_launches()
        out = serve(cfg, params, reqs, page_size=16,
                    num_pages=num_pages, device=dev,
                    between_rounds=between_rounds,
                    setup=lambda e: first.submitted(reqs),
                    cuda_graphs=graphs)
        engine = out["engine"]
        _check_drained(engine, f"graphs (cuda_graphs={graphs})")
        _check_captured(engine, f"{cfg.name} (cuda_graphs={graphs})")
        rs = out["round_seconds"]
        runs[graphs] = {
            "results": out["results"], "deltas": out["round_launches"],
            "kernels": launch_counts(),
            "decode_round_ms_median": float(np.median(rs[1:])) * 1e3,
            "prefill_ms": engine.stats["prefill_seconds"] * 1e3,
            **first.summary(),
            "tokens_per_s": out["tokens"] / out["seconds"],
            **_graph_stats(engine)}
        del engine, out
        _free_card()
    off, on = runs[False], runs[True]
    if on["results"] != off["results"]:
        raise AssertionError(f"{cfg.name}: streams differ with graphs on")
    if on["deltas"] != off["deltas"]:
        raise AssertionError(f"{cfg.name}: launches_by_kind deltas differ "
                             "with graphs on")
    if on["kernels"] != off["kernels"]:
        raise AssertionError(f"{cfg.name}: kernel launches differ with "
                             f"graphs on: {_nonzero(on['kernels'])} against "
                             f"{_nonzero(off['kernels'])}")
    if on["traces"] != off["traces"]:
        raise AssertionError(f"{cfg.name}: step-cache misses differ with "
                             f"graphs on: {on['traces']} {off['traces']}")
    drop = ("results", "deltas", "kernels")
    return {"arch": cfg.name, "layers": cfg.num_layers,
            "graphs_off": {k: v for k, v in off.items() if k not in drop},
            "graphs_on": {k: v for k, v in on.items() if k not in drop},
            "streams_identical": True, "launch_deltas_identical": True,
            "kernel_launches": _nonzero(on["kernels"]),
            # phase 4's EOS rule, from this workload's greedy stream 2
            "eos_token": off["results"][2][8]}


def chunked_ab(dev, cfg, params, eos_token) -> dict:
    """Phase 15's chunked half: phase 4's workload (:func:`_chunked_serve`)
    with ``cuda_graphs`` off, then on, in this process.  Required:
    identical streams, ``launches_by_kind`` deltas, kernel launch counts
    and step-cache misses, every key met twice captured and none met
    once.  Reported: the median host milliseconds of each step kind
    (chunk, mixed, decode block), also apart for the steps that met a
    key first (eager with graphs on too), those that captured a graph
    and those that only replayed, the prefill seconds, the requests'
    TTFT (requests 4-7 from their late submission), the captures and
    the seconds of the first uses and the captures, and the graphs'
    pool."""
    from repro_torch.kernels import launch_counts, reset_launches

    runs = {}
    for graphs in (False, True):
        reset_launches()
        uses, first = [], _FirstTokens()
        out = _chunked_serve(dev, cfg, params, eos_token,
                             cuda_graphs=graphs, uses=uses, first=first)
        engine = out["engine"]
        split = {}
        prev = (0, 0)
        for d, sec, now in zip(out["round_launches"], out["round_seconds"],
                               uses):
            use = ("first_use" if now[0] != prev[0] else
                   "capture" if now[1] != prev[1] else "replay")
            prev = now
            split.setdefault(_round_kind(d), {
                "first_use": [], "capture": [], "replay": []})[use].append(
                    sec * 1e3)
        _check_drained(engine, f"chunked graphs (cuda_graphs={graphs})")
        _check_captured(engine, f"chunked (cuda_graphs={graphs})")
        steps = _steps(out)
        runs[graphs] = {
            "results": out["results"], "deltas": out["round_launches"],
            "kernels": launch_counts(),
            "step_kinds": steps["step_kinds"],
            "step_ms_median": steps["step_ms_median"],
            "step_ms_median_by_use": {
                k: {m: float(np.median(v)) if v else None
                    for m, v in d.items()} for k, d in split.items()},
            "steps_by_use": {k: {m: len(v) for m, v in d.items()}
                             for k, d in split.items()},
            "prefill_ms": engine.stats["prefill_seconds"] * 1e3,
            **first.summary(),
            "tokens_per_s": out["tokens"] / out["seconds"],
            "rng_ctr": engine.rng_ctr, **_graph_stats(engine)}
        del engine, out
        _free_card()
    off, on = runs[False], runs[True]
    for key in ("results", "deltas", "kernels", "traces", "rng_ctr"):
        if on[key] != off[key]:
            raise AssertionError(f"chunked: {key} differ with graphs on")
    drop = ("results", "deltas", "kernels")
    return {"arch": cfg.name, "layers": cfg.num_layers,
            "max_prefill_chunk": 256, "decode_block_rounds": 8,
            "graphs_off": {k: v for k, v in off.items() if k not in drop},
            "graphs_on": {k: v for k, v in on.items() if k not in drop},
            "streams_identical": True, "launch_deltas_identical": True,
            "kernel_launches": _nonzero(on["kernels"])}


def graphs_phase(dev, cfg, params) -> dict:
    """Phase 15: :func:`graphs_ab` for granite-3-8b (phase 3's workload,
    full width and depth), :func:`chunked_ab` (phase 4's, request 2's
    EOS from the graphs-off greedy stream, as phase 4 takes it from
    phase 3's), phase 8(b)'s open loop with graphs off then on (TTFT
    and ITL), and :func:`graphs_ab` for mamba2-1.3b (phase 10(a)'s, full
    width and depth, on its 256-row state arena).  ``main`` adds each
    model's profiled replay of a decode round from phase 5 (which runs
    after, since the profiler leaves host cost behind): the host's calls
    that put work on the card against the device events it ran, and the
    card's busy share of the round."""
    from repro_torch.configs import ARCHS
    from repro_torch.serving.engine import Request

    granite = graphs_ab(dev, cfg, params,
                        lambda: granite_requests(cfg, Request), 1024)
    chunked = chunked_ab(dev, cfg, params, granite.pop("eos_token"))
    open_loop = {}
    for graphs in (False, True):
        line, _ = _open_loop(dev, cfg, params, cuda_graphs=graphs)
        open_loop["graphs_on" if graphs else "graphs_off"] = {
            k: line[k] for k in ("ttft_p50_ms", "ttft_p99_ms", "itl_p50_ms",
                                 "itl_p99_ms", "goodput_rps", "wall_s",
                                 "prefill_ms",
                                 "traces", "graphs_captured",
                                 "first_use_seconds", "capture_seconds",
                                 "graph_pool_gib")}
        _free_card()
    scfg = ARCHS["mamba2-1.3b"]
    sparams, _ = _model_params(dev, scfg, 10)

    def ssm_requests():
        return seeded_requests(scfg, Request, 8, 97, 450, 32)

    mamba = graphs_ab(dev, scfg, sparams, ssm_requests, 256)
    mamba.pop("eos_token")
    del sparams
    _free_card()
    # each workload's prefill and TTFT tail with graphs off and on, and
    # the host seconds of the first uses and captures with graphs on
    summary = {}
    for name, off, on in (
            ("granite", granite["graphs_off"], granite["graphs_on"]),
            ("granite_chunked", chunked["graphs_off"], chunked["graphs_on"]),
            ("granite_open_loop", open_loop["graphs_off"],
             open_loop["graphs_on"]),
            ("mamba2", mamba["graphs_off"], mamba["graphs_on"])):
        summary[name] = {
            "prefill_ms_off_on": [off["prefill_ms"], on["prefill_ms"]],
            "ttft_p99_ms_off_on": [off["ttft_p99_ms"], on["ttft_p99_ms"]],
            "first_use_seconds": on["first_use_seconds"],
            "capture_seconds": on["capture_seconds"]}
    return {"phase": "graphs", "summary": summary, "granite": granite,
            "granite_chunked": chunked, "granite_open_loop": open_loop,
            "mamba2": mamba}


# ---------------------------------------------------------------------- #
# Phase 8: prefix-cache serving with the zero scan, closed and open loop
# ---------------------------------------------------------------------- #

PREFIX_KW = dict(page_size=16, max_prefill_chunk=256, mixed_rounds=True,
                 decode_block_rounds=8, prefix_cache=True)
SYS_LEN, TAIL_LEN = 512, 40


def tenant_prompts(cfg, n_tenants, per_tenant, seed):
    """``n_tenants`` lists of prompts: each tenant's 512-token system
    prompt (32 pages) followed by a fresh 40-token tail per request."""
    from repro_torch.launch.serve_async import shared_prefix_prompts

    return [shared_prefix_prompts(per_tenant, cfg.vocab_size,
                                  prefix_len=SYS_LEN, tail_len=TAIL_LEN,
                                  seed=seed + t)
            for t in range(n_tenants)]


def _timed_scans(engine, log):
    """Turn the zero scan on and time each scan on the host clock: a
    scan returns its flags to the host, so it waits for the card."""
    cache = engine.cache
    cache.enable_zero_scan()
    scan = cache.scan_zero_pages

    def timed(pages):
        t0 = time.perf_counter()
        out = scan(pages)
        log.append((time.perf_counter() - t0) * 1e3)
        return out

    cache.scan_zero_pages = timed


def _clear_and_audit(engine, what):
    """clear_prefix() with the audit: every freed page zero, none in
    use."""
    before = engine.cache.queue.snapshot()
    evicted = engine.cache.clear_prefix()
    st = engine.cache.stats
    if st["zero_audit_failures"] or not st["zero_audit_pages"]:
        raise AssertionError(f"{what}: zero audit {st}")
    if engine.cache.pages_in_use:
        raise AssertionError(f"{what}: {engine.cache.pages_in_use} pages "
                             "in use after clear_prefix")
    return {"nodes_evicted": evicted,
            "launches": engine.cache.queue.delta(before)}


def serving_prefix(dev, cfg, params) -> dict:
    """Phase 8 (a): 4 tenants one after another on a 96-page arena, each
    a 512-token system prompt and 4 requests with 40-token tails, all
    greedy with 32 new tokens; a tenant's first request runs until its
    prompt is committed, then its other three arrive and hit the cached
    system prompt.  A tenant's live requests need about 52 pages and
    leave 40 indexed, so the third tenant must evict the first's cold
    prefix.  (b): 16 requests of one system prompt through AsyncServer
    under Poisson arrivals at 4 requests/s on a fresh 1024-page engine,
    with a TTFT SLO that sheds nothing.  Both run the zero scan and end
    with clear_prefix()'s audit."""
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.serve import serve
    from repro_torch.serving.engine import Request

    tenants = [[Request(10 * t + i, p, max_new_tokens=32, temperature=0.0)
                for i, p in enumerate(ps)]
               for t, ps in enumerate(tenant_prompts(cfg, 4, 4, 100))]
    state = {"t": 0, "others": False}

    def between_rounds(engine, i):
        reqs = tenants[state["t"]]
        if not state["others"]:
            if reqs[0].req_id in engine.active or reqs[0].done:
                for r in reqs[1:]:      # the system prompt is committed
                    engine.submit(r)
                state["others"] = True
        elif not engine.has_work and state["t"] + 1 < len(tenants):
            state["t"] += 1
            state["others"] = False
            engine.submit(tenants[state["t"]][0])

    scans_a = []
    reset_launches()
    out = serve(cfg, params, [tenants[0][0]], num_pages=96, device=dev,
                between_rounds=between_rounds,
                setup=lambda e: _timed_scans(e, scans_a), **PREFIX_KW)
    engine = out["engine"]
    cleared = _clear_and_audit(engine, "closed loop")
    counts = launch_counts()
    results = out["results"]
    check_streams(cfg, {i: results[r.req_id] for i, r in
                        enumerate(r for ts in tenants for r in ts)}, 16)
    st, cst = engine.stats, engine.cache.stats
    if not (st["prefix_hits"] > 0 and st["prefix_evictions"] > 0):
        raise AssertionError(f"closed loop: no prefix hit or eviction {st}")
    if engine.cache.queue.launches_by_kind.get("page_zero_scan", 0) == 0:
        raise AssertionError("closed loop: no page_zero_scan launch")
    missing = [k for k in PREFIX_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the path: {missing}")
    closed = {
        "tenants": 4, "requests_per_tenant": 4, "num_pages": 96,
        "prompt_len": SYS_LEN + TAIL_LEN,
        "tokens": out["tokens"], "seconds": out["seconds"],
        "tokens_per_s": out["tokens"] / out["seconds"], **_steps(out),
        "prefix": {k: st[k] for k in ("prefix_hits", "prefix_hit_tokens",
                                      "prefix_evictions")},
        "zero_scan": {k: cst[k] for k in ("init_skips_zero",
                                          "zero_audit_pages",
                                          "zero_audit_failures")},
        "scans": len(scans_a),
        "scan_host_ms_median": float(np.median(scans_a)),
        "scan_host_ms_total": float(np.sum(scans_a)),
        "launches_by_kind": _nonzero(engine.cache.queue.launches_by_kind),
        "saved_by_kind": dict(engine.cache.queue.saved_by_kind),
        "clear_prefix": cleared, "kernel_launches": dict(counts),
        **_graph_stats(engine), "pages_in_use": engine.cache.pages_in_use}
    del engine, out
    open_loop, counts_b = _open_loop(dev, cfg, params)
    total = {k: counts[k] + counts_b[k] for k in counts}
    return {"phase": "serve_prefix", "arch": cfg.name,
            "layers": cfg.num_layers, **{k: v for k, v in PREFIX_KW.items()},
            "zero_scan": True, "closed_loop": closed, "open_loop": open_loop,
            "kernel_launches": total}


def _open_loop(dev, cfg, params, cuda_graphs=True) -> tuple:
    """Phase 8 (b) on a fresh engine: returns its line and the kernel
    launch counts of the run."""
    import asyncio
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.serve_async import (poisson_open_loop,
                                                shared_prefix_prompts)
    from repro_torch.serving.engine import PagedEngine
    from repro_torch.serving.server import AsyncServer

    scans_b = []
    reset_launches()
    eng = PagedEngine(cfg, params, num_pages=1024, device=dev,
                      cuda_graphs=cuda_graphs, **PREFIX_KW)
    _timed_scans(eng, scans_b)
    prompts = shared_prefix_prompts(16, cfg.vocab_size, prefix_len=SYS_LEN,
                                    tail_len=TAIL_LEN, seed=200)

    async def go():
        async with AsyncServer(eng, ttft_slo_ms=120e3) as srv:
            return await poisson_open_loop(srv, prompts, rate_rps=4.0,
                                           max_new_tokens=32), dict(srv.stats)

    res, srv_stats = asyncio.run(asyncio.wait_for(go(), timeout=600))
    streams = res.pop("streams")
    if res["rejected"] or res["completed"] != len(prompts) \
            or any(len(s.tokens) != 32 for s in streams):
        raise AssertionError(f"open loop: {res}")
    cleared_b = _clear_and_audit(eng, "open loop")
    counts_b = launch_counts()
    if eng.stats["prefix_hits"] == 0 or counts_b["page_zero_scan"] == 0:
        raise AssertionError(f"open loop: {eng.stats} {counts_b}")
    open_loop = {
        "requests": len(prompts), "rate_rps": 4.0, "ttft_slo_ms": 120e3,
        **{k: res[k] for k in ("rejected", "completed", "good",
                               "goodput_rps", "goodput_tok_s", "wall_s",
                               "ttft_p50_ms", "ttft_p99_ms", "itl_p50_ms",
                               "itl_p99_ms")},
        "server": srv_stats,
        "prefix": {k: eng.stats[k] for k in ("prefix_hits",
                                             "prefix_hit_tokens",
                                             "prefix_evictions")},
        "zero_scan": {k: eng.cache.stats[k] for k in (
            "init_skips_zero", "zero_audit_pages", "zero_audit_failures")},
        "prefill_ms": eng.stats["prefill_seconds"] * 1e3,
        "scans": len(scans_b),
        "scan_host_ms_median": float(np.median(scans_b)),
        "launches_by_kind": _nonzero(eng.cache.queue.launches_by_kind),
        "saved_by_kind": dict(eng.cache.queue.saved_by_kind),
        "clear_prefix": cleared_b, "kernel_launches": dict(counts_b),
        **_graph_stats(eng), "pages_in_use": eng.cache.pages_in_use}
    del eng
    return open_loop, counts_b


# ---------------------------------------------------------------------- #
# Phase 9: TorchLib.bitwise through the op queue at full size
# ---------------------------------------------------------------------- #


def ambit_lib(dev, shape=(40, 1024, 16, 8, 128)) -> tuple:
    """``TorchLib.bitwise`` on a deferred lib bound to a full-size (k, v)
    arena pair (40 layers, 1024 pages of 16 x 8 x 128 bf16): an OR, an
    AND and a NOT batch of 16 page pairs in one slab, each flush one
    kernel launch over the pair (``LAUNCHES``) while the queue counts two
    for its kind (one per arena, the JAX package's count), the arenas
    held bit for bit against the plain versions."""
    from repro_torch.core.allocator import SubarrayAllocator, arena_groups
    from repro_torch.core.pimolib import Blocking, TorchLib
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.kernels.ambit import ref as amb_ref

    gen = torch.Generator(device=dev).manual_seed(9)
    arenas = [torch.randn(shape, generator=gen, device=dev,
                          dtype=torch.bfloat16) for _ in range(2)]
    alloc = SubarrayAllocator(arena_groups(4, shape[1] // 4))
    lib = TorchLib(buffers=arenas, layered=True, allocator=alloc,
                   deferred=True)
    g = alloc.group_ids()[1]
    src, dst = alloc.alloc(16, group=g), alloc.alloc(16, group=g)
    s_t = torch.tensor(src.rows, device=dev)
    d_t = torch.tensor(dst.rows, device=dev)
    reset_launches()
    deltas = {}
    for op in ("or", "and", "not"):
        want = [a.clone() for a in arenas]
        for w in want:
            if op == "not":
                amb_ref.page_not_batched(w, s_t, d_t)
            else:
                amb_ref.page_bitwise_batched(w, s_t, d_t, op)
        before = lib.queue.snapshot()
        kernels = sum(launch_counts().values())
        t0 = time.perf_counter()
        rec = lib.bitwise(op, src, dst, blocking=Blocking.FIN)
        host_ms = (time.perf_counter() - t0) * 1e3
        delta = lib.queue.delta(before)
        kernels = sum(launch_counts().values()) - kernels
        if delta != {f"page_{op}": 2} or rec.launches != 2 or kernels != 1:
            raise AssertionError(f"bitwise {op}: queue launches {delta}, "
                                 f"{kernels} kernel launches")
        for a, w in zip(arenas, want):
            if not same_bits(a, w):
                raise AssertionError(f"bitwise {op} disagrees with the "
                                     "plain version")
        deltas[op] = {"launches": delta, "kernel_launches": kernels,
                      "host_ms": host_ms}
        del want
    counts = launch_counts()
    got = {k: counts[k] for k in LIB_KERNELS}
    if got != {"page_bitwise_batched": 2, "page_not_batched": 1}:
        raise AssertionError(f"phase 9's kernel launches {got}: one a "
                             "kind over the pair expected")
    out = {"phase": "ambit_lib", "arena": list(shape), "pages": 16,
           "ops": deltas, "bitwises": lib.stats["bitwises"],
           "kernel_launches": dict(counts)}
    del arenas, lib
    return out, counts


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

    class Recording(_Recording, PagedEngine):
        pass

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
# Phases 10-12: paged SSM, hybrid and MoE serving at full width
# ---------------------------------------------------------------------- #
# Phases 16-18: the eager prefill oracle, the dense forward, llava
# ---------------------------------------------------------------------- #


def eager_oracle(dev, cfg, params) -> dict:
    """Phase 16: granite-3-8b at full width and depth on phase 6's
    weights (``wq`` x 0.01), phase 6's three prompts one at a time (8
    greedy new tokens each): the fused path first, recording its logits,
    then ``fused_prefill=False`` teacher-forced by it.  The eager
    first-token logits are held within ``LOGIT_ATOL`` of the fused
    ones, and every greedy choice where the fused margin exceeds
    ``MARGIN`` must agree; the eager prefill's launches are one
    ``kv_write`` flush (``kv_scatter``, counted two by the queue) and
    no ``fused_prefill``; 0 pages in use at the end."""
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.serving.engine import PagedEngine, Request

    class Recording(_Recording, PagedEngine):
        pass

    prompts = [r.prompt for r in granite_requests(cfg, Request)]
    out = {"phase": "eager_oracle", "arch": cfg.name,
           "layers": cfg.num_layers, "wq_scale": 0.01, "requests": {}}
    checked = agree = total = 0
    reset_launches()
    for i in (0, 2, 4):
        runs = {}
        for name, kw in (("fused", {}), ("eager", {"fused_prefill": False})):
            forced = runs["fused"][0].logits if name == "eager" else None
            eng = Recording(cfg, params, page_size=16, num_pages=256,
                            device=dev, forced=forced, **kw)
            eng.submit(Request(i, prompts[i], max_new_tokens=8,
                               temperature=0.0))
            before = eng.cache.queue.snapshot()
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            delta = eng.cache.queue.delta(before)
            stream = eng.run()[i]
            if eng.cache.pages_in_use:
                raise AssertionError(f"eager oracle ({name}): "
                                     f"{eng.cache.pages_in_use} pages "
                                     "leaked")
            runs[name] = (eng, stream, delta, first_ms)
        (f_eng, f_stream, _, f_ms), (e_eng, e_stream, e_delta, e_ms) = \
            runs["fused"], runs["eager"]
        if e_delta.get("kv_write") != 2 or "fused_prefill" in e_delta:
            raise AssertionError(f"eager prefill launches {e_delta}")
        first_err = float((e_eng.logits[0] - f_eng.logits[0]).abs().max())
        if first_err > LOGIT_ATOL:
            raise AssertionError(f"eager and fused first-token logits "
                                 f"differ by {first_err}")
        step_err = 0.0
        for ours, ref in zip(e_eng.logits, f_eng.logits):
            step_err = max(step_err, float((ours - ref).abs().max()))
            top2 = ref.topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > MARGIN
            checked += int(sure.sum())
            agree += int((ours.argmax(-1) == ref.argmax(-1))[sure].sum())
            total += ref.shape[0]
        if e_stream != f_stream:
            raise AssertionError("teacher-forced streams differ")
        out["requests"][i] = {
            "prompt_len": int(len(prompts[i])),
            "first_logits_max_abs_err": first_err,
            "logits_max_abs_err": step_err,
            "eager_first_step_ms": e_ms, "fused_first_step_ms": f_ms,
            "eager_prefill_launches": e_delta}
    if agree != checked:
        raise AssertionError(f"greedy choices differ where the margin "
                             f"exceeds {MARGIN}: {agree}/{checked}")
    counts = launch_counts()
    _check_launched(counts, ("kv_scatter", "paged_attention"),
                    "eager oracle")
    out.update(logit_atol=LOGIT_ATOL, margin=MARGIN,
               choices_checked=checked, choices_total=total,
               kernel_launches=_nonzero(counts))
    return out


def _scale_queries(params, scale: float) -> None:
    """Scale every attention sublayer's ``wq`` (self, cross and MLA) in
    place: phase 6's cure for the near-one-hot attention of random
    weights at full width (query and key entries of 10-30 give scores of
    hundreds, whose near-ties amplify any rounding difference)."""
    for name, group in params.items():
        if not name.startswith("group"):
            continue
        for key, sub in group.items():
            if key.endswith(("_attn", "_mla", "_cross")):
                sub["attn"]["wq"].mul_(scale)


def forward_cross_check(dev) -> dict:
    """Phase 17: ``models/transformer.forward`` (train mode) for every
    family at 2 layers, the same random weights (a seeded generator on
    the card, copied to the host) on the card and on the CPU, both with
    ``layers.COMPUTE_DTYPE`` set to float32 for the phase: logits within
    ``FORWARD_RTOL`` of the largest |logit| (every family is run and
    printed before any failure raises), every ``wq`` scaled by 0.01
    first, as in phase 6 (unscaled, llava's 2-layer logits part by
    2.2e-3 of the largest on an H100, on float32 rounding alone).  A
    probe first multiplies one (272, 7168) x (7168, 20480) float32 pair
    on the card and in float64 on the host: its relative error is
    float32's (about 1e-6) unless the card's matmuls run in TF32 (about
    1e-3).  Full width for granite, llava (16 tokens after its 256 patch
    embeds), mamba2 and seamless (1 + 1 layers, 32 frames); ``reduced()``
    widths for llama4-scout (a leading dense layer), the MLA deepseek
    and jamba (one 4-layer period), whose full-width expert layers (2-10
    B parameters each) would run expert-dense on the host CPU in
    float32."""
    from repro_torch.configs import ARCHS, ParallelConfig, reduced
    from repro_torch.models import layers, transformer as T
    from repro_torch.models.params import init_params, tree_map

    full = dataclasses.replace
    cases = {
        "dense": full(ARCHS["granite-3-8b"], num_layers=2),
        "vlm": full(ARCHS["llava-next-34b"], num_layers=2),
        "ssm": full(ARCHS["mamba2-1.3b"], num_layers=2),
        "encdec": full(ARCHS["seamless-m4t-medium"], num_layers=2,
                       enc_layers=1, dec_layers=1),
        "moe": reduced(ARCHS["llama4-scout-17b-a16e"], num_layers=2),
        "mla": reduced(ARCHS["deepseek-v2-236b"], num_layers=2),
        "hybrid": reduced(ARCHS["jamba-1.5-large-398b"], num_layers=4,
                          attn_every=4),
    }
    cases["moe"] = full(cases["moe"], moe=full(cases["moe"].moe,
                                               first_dense_layers=1))
    pcfg = ParallelConfig(remat="none", attention_impl="naive",
                          moe_impl="dense")
    rng = np.random.default_rng(17)
    a = torch.from_numpy(rng.normal(size=(272, 7168)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(7168, 20480)).astype(np.float32))
    ref = a.double() @ b.double()
    probe = float(((a.to(dev) @ b.to(dev)).double().cpu() - ref).abs().max()
                  / ref.abs().max())
    out = {"phase": "forward_cross_check", "compute_dtype": "float32",
           "rtol": FORWARD_RTOL, "wq_scale": 0.01,
           "float32_matmul_precision": torch.get_float32_matmul_precision(),
           "cuda_matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "gemm_probe_rel_err": probe, "families": {}}
    del a, b, ref
    failed = []
    saved = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = torch.float32
    try:
        for family, cfg in cases.items():
            gen = torch.Generator(device=dev).manual_seed(17)
            p_gpu = init_params(T.model_defs(cfg), gen, dev, torch.bfloat16)
            _scale_queries(p_gpu, 0.01)
            p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
            batch = {"tokens": rng.integers(0, cfg.vocab_size, (1, 16))
                     .astype(np.int32)}
            fd = cfg.frontend_dim or cfg.d_model
            if family == "vlm":
                batch["patch_embeds"] = rng.normal(
                    size=(1, cfg.num_patch_tokens, fd)).astype(np.float32)
            if family == "encdec":
                batch["frames"] = rng.normal(size=(1, 32, fd)).astype(
                    np.float32)
            logits = {}
            for name, params, d in (("gpu", p_gpu, dev),
                                    ("cpu", p_cpu, "cpu")):
                b = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
                t0 = time.perf_counter()
                lg, _ = T.forward(cfg, pcfg, params, b, mode="train")
                logits[name] = lg.float().cpu()
                logits[f"{name}_s"] = time.perf_counter() - t0
            err = float((logits["gpu"] - logits["cpu"]).abs().max())
            top = float(logits["cpu"].abs().max())
            if not bool(torch.isfinite(logits["gpu"]).all()) \
                    or err > FORWARD_RTOL * top:
                failed.append(family)
            out["families"][family] = {
                "arch": cfg.name, "d_model": cfg.d_model,
                "kinds": [k for _, ks in T.layer_groups(cfg) for k in ks],
                "logits_shape": list(logits["gpu"].shape),
                "max_abs_logit": top, "max_abs_err": err,
                "rel_err": err / top, "card_s": logits["gpu_s"],
                "cpu_s": logits["cpu_s"]}
            del p_gpu, p_cpu
            _free_card()
    finally:
        layers.COMPUTE_DTYPE = saved
    if failed:
        raise AssertionError(f"forward: card and CPU logits differ beyond "
                             f"{FORWARD_RTOL} of the largest |logit| for "
                             f"{failed}: {json.dumps(out)}")
    return out


def _llava_depth(dev, cfg, num_pages, page_size, reserve) -> tuple:
    """The deepest cut of ``cfg`` (at most its own depth) whose bf16
    weights and KV arena fit the card's free memory less ``reserve``
    bytes, and the bytes each takes at that depth."""
    from repro_torch.models import transformer as T
    from repro_torch.models.params import param_count

    free, _ = torch.cuda.mem_get_info(dev)
    one = param_count(T.model_defs(dataclasses.replace(cfg, num_layers=1)))
    two = param_count(T.model_defs(dataclasses.replace(cfg, num_layers=2)))
    per_layer = 2 * (two - one)                 # bf16 bytes a layer
    fixed = 2 * one - per_layer                 # embeddings, norm, patch
    kv_layer = (2 * num_pages * page_size * cfg.num_kv_heads
                * cfg.resolved_head_dim * 2)
    depth = min(cfg.num_layers,
                int((free - reserve - fixed) // (per_layer + kv_layer)))
    return depth, {"free_bytes": free, "reserve_bytes": reserve,
                   "weight_bytes": fixed + depth * per_layer,
                   "kv_arena_bytes": depth * kv_layer,
                   "layer_bytes": per_layer, "kv_layer_bytes": kv_layer}


def serving_llava(dev) -> tuple:
    """Phase 18: llava-next-34b at full width (and full depth unless the
    card cannot hold it: :func:`_llava_depth`, the cut printed with its
    bytes) served text-only through the dense layout from a 256-page
    arena of 16 tokens: 4 greedy requests of 257-512 tokens, 32 new
    tokens, monolithic; then the same prompts chunked at 256 with mixed
    rounds and 8-round blocks, request 1 sampled.  Each run prints its
    decode round on the host clock, each step ending in its token
    transfer (monolithic: the median of the one-round steps; chunked:
    the K-blocks' milliseconds over their rounds), against the round's
    bound (every weight a round reads and each row's KV at its mid-run
    length, read once at 3.35 TB/s), and its tokens/s.  Returns the line
    and the kernel launches of both runs."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.params import param_count
    from repro_torch.serving.engine import Request

    _free_card()
    full = ARCHS["llava-next-34b"]
    pages, ps = 256, 16
    depth, mem = _llava_depth(dev, full, pages, ps, reserve=6 * 2**30)
    if depth < 1:
        raise AssertionError(f"llava-next-34b: not one layer fits ({mem})")
    cfg = dataclasses.replace(full, num_layers=depth)
    params, init_s = _model_params(dev, cfg, 18)
    weight_bytes = param_count(T.model_defs(cfg)) * 2
    kv_tok = 2 * depth * cfg.num_kv_heads * cfg.resolved_head_dim * 2
    line = {"phase": "serve_llava", "arch": cfg.name, "layers": depth,
            "full_depth": full.num_layers, "d_model": cfg.d_model,
            "heads": [cfg.num_heads, cfg.num_kv_heads], "d_ff": cfg.d_ff,
            "params": param_count(T.model_defs(cfg)),
            "init_seconds": init_s, "memory": mem, "runs": {}}
    # a decode round reads every weight but the input embedding and the
    # patch projection (the tokens' rows only), and each row's KV
    read_bytes = weight_bytes - 2 * cfg.d_model * (
        cfg.frontend_dim + (0 if cfg.tie_embeddings else cfg.vocab_size))
    total = None
    for name, temps, kw, need in (
            ("monolithic", lambda i: 0.0, {}, MOE_KERNELS),
            ("chunked", lambda i: float(i == 1),
             dict(max_prefill_chunk=256, mixed_rounds=True,
                  decode_block_rounds=8), CHUNKED_KERNELS)):
        reqs = seeded_requests(cfg, Request, 4, 257, 513, 32,
                               temperature=temps)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        out = serve(cfg, params, reqs, page_size=ps, num_pages=pages,
                    device=dev, **kw)
        counts = launch_counts()
        engine = out["engine"]
        _check_launched(counts, need, f"serve_llava ({name})")
        _check_drained(engine, f"serve_llava ({name})")
        check_streams(cfg, out["results"], 4, new_tokens=32)
        steps = _steps(out)
        ms = steps["step_ms"]
        if kw:
            # the K-blocks' rounds: all rounds but the mixed rounds'
            block_rounds = (engine.stats["decode_rounds"]
                            - len(ms.get("mixed", []))
                            - len(ms.get("decode", [])))
            round_ms = sum(ms.get("decode_block", [])) / max(block_rounds, 1)
        else:
            round_ms = float(np.median(ms["decode"]))
        # each row's KV at its mid-run length
        ctx = sum(len(r.prompt) + 16 for r in reqs)
        bound_ms = (read_bytes + ctx * kv_tok) / HBM_BYTES_PER_S * 1e3
        line["runs"][name] = {
            **kw, "prompt_lens": [int(len(r.prompt)) for r in reqs],
            "decode_round_ms": round_ms,
            "decode_round_bound_ms": bound_ms,
            "decode_round_share_of_bound": bound_ms / round_ms,
            "decode_round_bound_by": "bytes",
            "tokens": out["tokens"], "seconds": out["seconds"],
            "tokens_per_s": out["tokens"] / out["seconds"],
            "prefill_s": engine.stats["prefill_seconds"], **steps,
            "launches_by_kind": _nonzero(engine.cache.queue.launches_by_kind),
            "kernel_launches": _nonzero(counts), **_graph_stats(engine),
            "pages_in_use": engine.cache.pages_in_use,
            "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
        total = counts if total is None else {k: total[k] + counts[k]
                                              for k in counts}
        del engine, out
    del params
    _free_card()
    return line, total


# ---------------------------------------------------------------------- #


def _free_card() -> None:
    """Return the caching allocator's free blocks before the next
    model (the callers drop their engines and weights first)."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _model_params(dev, cfg, seed):
    """``cfg``'s parameters as random bf16 from a seeded generator on the
    card, and the seconds it took."""
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(T.model_defs(cfg), gen, dev, torch.bfloat16)
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def seeded_requests(cfg, Request, n, lo, hi, new_tokens,
                    temperature=lambda i: 0.0):
    """``n`` requests with prompt lengths in [lo, hi) and their tokens
    from numpy seed 0, request ``i`` at ``temperature(i)``."""
    rng = np.random.default_rng(0)
    lens = rng.integers(lo, hi, n)
    return [Request(i, rng.integers(0, cfg.vocab_size, m).astype(np.int32),
                    max_new_tokens=new_tokens, temperature=temperature(i))
            for i, m in enumerate(lens)]


def _check_launched(counts, need, what) -> None:
    missing = [k for k in need if counts[k] == 0]
    if missing:
        raise AssertionError(f"{what}: kernels not launched on the path: "
                             f"{missing}")


def _check_drained(engine, what) -> None:
    st = engine.cache.state
    if engine.cache.pages_in_use or (st is not None and st.rows_in_use):
        raise AssertionError(
            f"{what}: {engine.cache.pages_in_use} pages and "
            f"{st.rows_in_use if st is not None else 0} state rows in use "
            "at the end")


def serving_ssm(dev) -> dict:
    """Phase 10: mamba2-1.3b at full width and depth (48 layers, d_model
    2048, 1.34 B parameters in bf16), page size 16, 256 pages: a 25.8 GB
    SSD state arena (256 rows x 48 layers x 2 MiB), a 0.32 GB conv
    arena and the 1.6 GB phantom KV pair.  8 prompts of 97-449 tokens,
    32 new tokens each.  (a) monolithic greedy through ``serve``, a fork
    of a live sequence (``state_copy``) and its free (``state_init``)
    between rounds; then one eager round on a ``fused=False`` engine,
    whose state write goes through the op queue (``ssm_state_write``).
    (b) chunked at 256 (the SSD chunk size), mixed rounds, 8-round
    decode blocks, odd ids sampled at temperature 1.0, requests 4-7
    arriving after the second step.  No attention: ``paged_attention``,
    ``flash_*`` and ``kv_scatter`` must not launch, ``state_scatter``
    at least once a step (one launch writes both arenas)."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.params import param_count
    from repro_torch.serving.engine import PagedEngine, Request

    cfg = ARCHS["mamba2-1.3b"]
    params, init_s = _model_params(dev, cfg, 10)
    n_params = param_count(T.model_defs(cfg))
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    row_bytes = cfg.num_layers * (
        (d_in // s.head_dim) * s.head_dim * s.state_dim * 4
        + (s.conv_width - 1) * (d_in + 2 * s.state_dim) * 2)
    bound_ms = (n_params * 2 + 8 * 2 * row_bytes) / HBM_BYTES_PER_S * 1e3
    reqs = seeded_requests(cfg, Request, 8, 97, 450, 32)
    forked = {}

    def between_rounds(engine, i):
        if i == 1:
            for rid in sorted(engine.active):
                if engine.cache.seqs[rid].length % engine.cache.page_size:
                    forked.update(counted_fork(engine, rid))
                    break
        elif i == 2 and forked:
            engine.cache.free(1000)

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    out = serve(cfg, params, reqs, page_size=16, num_pages=256, device=dev,
                between_rounds=between_rounds)
    counts = launch_counts()
    engine = out["engine"]
    by_kind = dict(engine.cache.queue.launches_by_kind)
    steps = len(out["round_seconds"])
    _check_launched(counts, SSM_KERNELS, "serve_ssm (a)")
    if not forked or not by_kind.get("state_copy") \
            or not by_kind.get("state_init"):
        raise AssertionError(f"serve_ssm (a): no state fork/free {by_kind}")
    # the pure SSM cache keeps a phantom KV arena pair, as the JAX
    # package does: its tail page is copied too
    check_fork(forked, {"page_copy": 2, "state_copy": 2}, "serve_ssm (a)")
    attn = {k: counts[k] for k in ("kv_scatter", "paged_attention",
                                   "flash_attention",
                                   "flash_attention_prefix")}
    if any(attn.values()) or counts["state_scatter"] < steps:
        raise AssertionError(f"serve_ssm (a): launches {counts}")
    _check_drained(engine, "serve_ssm (a)")
    check_streams(cfg, out["results"], 8)
    rs = out["round_seconds"]
    st = engine.stats
    mono = {"prompt_lens": [int(len(r.prompt)) for r in reqs],
            "prefill_s": st["prefill_seconds"],
            "prefill_tokens_per_s": sum(len(r.prompt) for r in reqs)
            / st["prefill_seconds"],
            "first_round_ms": rs[0] * 1e3,
            "decode_round_ms_median": float(np.median(rs[1:])) * 1e3,
            "decode_round_bound_ms": bound_ms,
            "tokens": out["tokens"], "seconds": out["seconds"],
            "tokens_per_s": out["tokens"] / out["seconds"],
            "forked_from": forked["from"], "fork_flush": forked,
            "launches_by_kind": _nonzero(by_kind),
            "kernel_launches": _nonzero(counts), **_graph_stats(engine),
            "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    total = dict(counts)
    del engine, out
    _free_card()

    # the eager oracle's round: its state write through the op queue
    reset_launches()
    eager = PagedEngine(cfg, params, page_size=16, num_pages=64, device=dev,
                        fused=False)
    for r in seeded_requests(cfg, Request, 2, 97, 450, 2):
        eager.submit(r)
    t0 = time.perf_counter()
    eager.run()
    torch.cuda.synchronize()
    e_counts = launch_counts()
    e_kind = eager.cache.queue.launches_by_kind
    G = cfg.num_layers
    if e_kind.get("ssm_state_write") != 2 \
            or e_kind.get("eager_ssm_layer") != G \
            or e_counts["state_scatter"] != 1 + 1:
        raise AssertionError(f"eager round: {_nonzero(e_kind)} "
                             f"{_nonzero(e_counts)}")
    _check_drained(eager, "eager round")
    eager_line = {"seconds": time.perf_counter() - t0,
                  "launches_by_kind": _nonzero(e_kind),
                  "kernel_launches": _nonzero(e_counts)}
    for k, v in e_counts.items():
        total[k] += v
    del eager
    _free_card()

    # (b) chunked, mixed rounds, K-blocks, sampled odd ids
    reqs = seeded_requests(cfg, Request, 8, 97, 450, 32,
                           temperature=lambda i: float(i % 2))
    late = reqs[4:]

    def arrive(engine, i):
        if i == 1:
            for r in late:
                engine.submit(r)

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    out = serve(cfg, params, reqs[:4], page_size=16, num_pages=256,
                device=dev, between_rounds=arrive, max_prefill_chunk=256,
                mixed_rounds=True, decode_block_rounds=8)
    counts = launch_counts()
    engine = out["engine"]
    by_kind = dict(engine.cache.queue.launches_by_kind)
    _check_launched(counts, SSM_CHUNKED_KERNELS, "serve_ssm (b)")
    for kind in ("fused_mixed", "fused_decode_block", "fused_prefill"):
        if not by_kind.get(kind):
            raise AssertionError(f"serve_ssm (b): no {kind} launch")
    if counts["paged_attention"] or counts["flash_attention_prefix"]:
        raise AssertionError(f"serve_ssm (b): attention launched {counts}")
    _check_drained(engine, "serve_ssm (b)")
    check_streams(cfg, out["results"], 8)
    chunked = {"max_prefill_chunk": 256, "decode_block_rounds": 8,
               "tokens": out["tokens"], "seconds": out["seconds"],
               "tokens_per_s": out["tokens"] / out["seconds"],
               **_steps(out), "rng_ctr": engine.rng_ctr,
               "launches_by_kind": _nonzero(by_kind),
               "kernel_launches": _nonzero(counts), **_graph_stats(engine),
               "peak_memory_gib": torch.cuda.max_memory_allocated(dev)
               / 2**30}
    for k, v in counts.items():
        total[k] += v
    del engine, out, params
    _free_card()
    return {"phase": "serve_ssm", "arch": cfg.name,
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "params": n_params, "init_seconds": init_s, "num_pages": 256,
            "state_row_bytes": row_bytes, "monolithic": mono,
            "eager_round": eager_line, "chunked": chunked,
            "kernel_launches": total}


def serving_hybrid(dev) -> dict:
    """Phase 11: jamba-1.5-large-398b cut to one period at full width
    (``num_layers=4, attn_every=4``: 3 Mamba sublayers with d_inner
    16384, one attention sublayer of 64 heads over 8 KV heads, two
    16-expert top-2 MoE layers with d_ff 24576, two dense MLPs; 22.98 B
    parameters in bf16), 128 pages: 4 greedy requests of 257-512 tokens,
    chunked at 256 with mixed rounds and 8-round blocks, 16 new tokens.
    Then llama4-scout-17b-a16e cut to 2 layers at full width (16 experts
    top-1 plus a shared expert, 40 heads over 8; 6.47 B parameters): 4
    greedy monolithic requests, 16 new tokens.  Each model's weights are
    freed before the next is drawn."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.params import param_count
    from repro_torch.serving.engine import Request

    lines = {}
    total = None
    for name, cfg, kw, need in (
            ("jamba", dataclasses.replace(ARCHS["jamba-1.5-large-398b"],
                                          num_layers=4, attn_every=4),
             dict(max_prefill_chunk=256, mixed_rounds=True,
                  decode_block_rounds=8), HYBRID_KERNELS),
            ("scout", dataclasses.replace(ARCHS["llama4-scout-17b-a16e"],
                                          num_layers=2), {},
             MOE_KERNELS)):
        params, init_s = _model_params(dev, cfg, 11)
        reqs = seeded_requests(cfg, Request, 4, 257, 513, 16)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        out = serve(cfg, params, reqs, page_size=16, num_pages=128,
                    device=dev, **kw)
        counts = launch_counts()
        engine = out["engine"]
        _check_launched(counts, need, f"serve_hybrid ({name})")
        _check_drained(engine, f"serve_hybrid ({name})")
        check_streams(cfg, out["results"], 4, new_tokens=16)
        lines[name] = {
            "arch": cfg.name, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "kinds": list(T.layer_groups(cfg)[0][1]),
            "params": param_count(T.model_defs(cfg)),
            "init_seconds": init_s, **kw,
            "prompt_lens": [int(len(r.prompt)) for r in reqs],
            "prefill_s": engine.stats["prefill_seconds"],
            "tokens": out["tokens"], "seconds": out["seconds"],
            "tokens_per_s": out["tokens"] / out["seconds"], **_steps(out),
            "launches_by_kind": _nonzero(engine.cache.queue.launches_by_kind),
            "kernel_launches": _nonzero(counts), **_graph_stats(engine),
            "pages_in_use": engine.cache.pages_in_use,
            "state_rows_in_use": (engine.cache.state.rows_in_use
                                  if engine.cache.state is not None else None),
            "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
        total = counts if total is None else {k: total[k] + counts[k]
                                              for k in counts}
        del engine, out, params
        _free_card()
    return {"phase": "serve_hybrid", **lines, "kernel_launches": total}


class _Recording:
    """Mixin for a ``PagedEngine`` that records its logits and, with
    ``forced``, takes every token from a reference run's logits (teacher
    forcing)."""

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


def ssm_cross_check(dev) -> dict:
    """Phase 12: mamba2-1.3b cut to 2 layers at full width, the same
    weights on the card and on the CPU (plain versions): the prefill's
    logits and 4 teacher-forced decode steps, greedy.  The first step is
    held within SSM_FIRST_ATOL; the decode steps are printed."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.params import tree_map
    from repro_torch.serving.engine import PagedEngine, Request

    class Recording(_Recording, PagedEngine):
        pass

    cfg = dataclasses.replace(ARCHS["mamba2-1.3b"], num_layers=2)
    p_gpu, _ = _model_params(dev, cfg, 12)
    p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (40, 57)]

    def run(params, d, forced=None):
        eng = Recording(cfg, params, page_size=16, num_pages=16, device=d,
                        forced=forced)
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, max_new_tokens=5, temperature=0.0))
        return eng, eng.run()

    ref_eng, ref_out = run(p_cpu, "cpu")
    gpu_eng, gpu_out = run(p_gpu, dev, forced=ref_eng.logits)
    errs = [float((a - b).abs().max())
            for a, b in zip(gpu_eng.logits, ref_eng.logits)]
    if len(errs) != 5 or errs[0] > SSM_FIRST_ATOL:
        raise AssertionError(f"card and CPU logits differ: {errs}")
    if gpu_out != ref_out:
        raise AssertionError("teacher-forced streams differ")
    _check_drained(gpu_eng, "ssm cross-check")
    del p_gpu, gpu_eng
    _free_card()
    return {"phase": "ssm_cross_check", "arch": cfg.name, "layers": 2,
            "d_model": cfg.d_model, "prompt_lens": [40, 57],
            "first_logits_max_abs_err": errs[0],
            "first_logits_atol": SSM_FIRST_ATOL,
            "decode_logits_max_abs_err": errs[1:]}


# ---------------------------------------------------------------------- #
# Phase 19: training
# ---------------------------------------------------------------------- #

# phase 19(a): one train step of reduced gemma-2b, card against CPU, both
# in float32 (TF32 off), AdamW's eps at 1e-3 (at 1e-8 the first update
# is sign(g), which a gradient at float32 noise flips: 2 * lr).  The loss
# sums float32 logits in other orders; the gradients' global norm follows
# the embedding's, which passes the first RMSNorm's backward (two nearly
# cancelling terms); a step-1 update moves a parameter by at most about
# lr(1) = 5e-4, and the two devices' updates are held within 1% of it
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GNORM_RTOL = 2e-4
TRAIN_UPDATE_ATOL = 5e-6
# phase 19(c): a resumed run's losses against an uninterrupted run's, if
# the card's atomics part them at all
RESTART_RTOL = 1e-6


def _small_gemma():
    """Phase 19(a)/(c)'s model: gemma-2b reduced to 2 layers, width 256,
    4 heads of 64 over 1 KV head, d_ff 1024, a 4096-token vocab (tied)."""
    from repro_torch.configs import ARCHS, reduced
    return reduced(ARCHS["gemma-2b"], num_layers=2, d_model=256, d_ff=1024,
                   vocab_size=4096, head_dim=64)


def _on(batch, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _attention_fan_in(params, cfg) -> None:
    """Rescale every attention projection in place from the init rule's
    fan-in (the second-to-last dim: heads for ``wq``, the one KV head for
    ``wk``/``wv``, head_dim for ``wo``) to its contraction's (d_model;
    heads x head_dim for ``wo``), so each draws at 1/sqrt(fan-in) of the
    product it enters.  Under the rule gemma's ``wk``/``wv`` draw at std
    1: its scores reach hundreds and the gradient norm grows ~500x every
    two layers, ~1e13 at 18 (phase 19(b) prints it), where a clip to 1
    leaves AdamW's updates below its eps and the loss cannot fall.  The
    init rule's fan-in is read from the definitions, so a rank's slices
    (ZeRO-3, phase 22) scale as the whole leaves do."""
    from repro_torch.models import transformer as T

    defs = T.model_defs(cfg)
    for name, group in params.items():
        if not name.startswith("group"):
            continue
        for key, sub in group.items():
            if not key.endswith("_attn"):
                continue
            for w, t in sub["attn"].items():
                fan = (cfg.num_heads * cfg.resolved_head_dim if w == "wo"
                       else cfg.d_model)
                init = defs[name][key]["attn"][w].shape[-2]
                t.mul_((init / fan) ** 0.5)


def train_cross_check(dev) -> dict:
    """Phase 19(a): one ``make_train_step`` step (AdamW, float32 master
    weights from a seeded generator on the card, copied to the host) of
    ``_small_gemma`` over a ``SyntheticLM`` batch of 4 x 128 with
    ``attention_chunk`` 64, on the card and on the CPU, both with
    ``layers.COMPUTE_DTYPE`` float32: the loss, grad_norm and every
    updated parameter held to ``TRAIN_*`` (the tolerances' reasons stand
    beside them), with remat "full" and "none".  The attention
    projections are drawn at their contraction's fan-in
    (``_attention_fan_in``)."""
    from repro_torch.configs import (OptimizerConfig, ParallelConfig,
                                     ShapeConfig)
    from repro_torch.data.pipeline import PipelineConfig, SyntheticLM
    from repro_torch.models import layers, transformer as T
    from repro_torch.models.params import init_params, tree_leaves, tree_map
    from repro_torch.training.train_step import make_train_step

    cfg = _small_gemma()
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=8, eps=1e-3)
    batch = SyntheticLM(cfg, ShapeConfig("t", 128, 4, "train"),
                        PipelineConfig(seed=19)).batch(0)
    p_gpu = init_params(T.model_defs(cfg),
                        torch.Generator(device=dev).manual_seed(19), dev)
    _attention_fan_in(p_gpu, cfg)
    p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
    out = {"phase": "train_cross_check", "attention_fan_in": True, "arch": cfg.name,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "batch": [4, 128],
           "attention_chunk": 64, "compute_dtype": "float32",
           "eps": ocfg.eps, "loss_rtol": TRAIN_LOSS_RTOL,
           "grad_norm_rtol": TRAIN_GNORM_RTOL,
           "update_atol": TRAIN_UPDATE_ATOL, "remat": {}}
    failed = []
    saved = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = torch.float32
    try:
        for remat in ("full", "none"):
            pcfg = ParallelConfig(remat=remat, attention_impl="chunked",
                                  attention_chunk=64, moe_impl="dense")
            res = {}
            for name, params, d in (("gpu", p_gpu, dev), ("cpu", p_cpu,
                                                          "cpu")):
                init, step = make_train_step(cfg, pcfg, ocfg)
                t0 = time.perf_counter()
                st, m = step(init(tree_map(torch.clone, params)),
                             _on(batch, d))
                res[name] = ({k: float(v) for k, v in m.items()},
                             tree_map(lambda t: t.cpu(), st["params"]))
                res[f"{name}_s"] = time.perf_counter() - t0
            (mg, pg), (mc, pc) = res["gpu"], res["cpu"]
            err = max(float((a - b).abs().max()) for (_, a), (_, b) in
                      zip(tree_leaves(pg), tree_leaves(pc)))
            loss_rel = abs(mg["loss"] - mc["loss"]) / abs(mc["loss"])
            gn_rel = abs(mg["grad_norm"] - mc["grad_norm"]) / mc["grad_norm"]
            if not (np.isfinite(mg["loss"]) and loss_rel <= TRAIN_LOSS_RTOL
                    and gn_rel <= TRAIN_GNORM_RTOL
                    and err <= TRAIN_UPDATE_ATOL):
                failed.append(remat)
            out["remat"][remat] = {
                "loss": [mg["loss"], mc["loss"]], "loss_rel_err": loss_rel,
                "grad_norm": [mg["grad_norm"], mc["grad_norm"]],
                "grad_norm_rel_err": gn_rel, "params_max_abs_err": err,
                "card_s": res["gpu_s"], "cpu_s": res["cpu_s"]}
            res.clear()
    finally:
        layers.COMPUTE_DTYPE = saved
    del p_gpu
    _free_card()
    if failed:
        raise AssertionError(f"train step: card and CPU differ (remat "
                             f"{failed}): {json.dumps(out)}")
    return out


def _model_flops(cfg, n_params, b, s) -> tuple:
    """(model FLOPs of one training step, how they are counted): 6 N per
    token (forward 2 N, backward 4 N; N counts the tied table once, as
    the LM head's product) plus causal attention, QK^T and PV at 2 s^2 dh
    FLOPs a head each, halved by the mask, times 3 for the backward;
    remat's recomputation not counted."""
    tokens = b * s
    attn = 3 * 2 * b * cfg.num_heads * s * s * cfg.resolved_head_dim \
        * cfg.num_layers
    return 6 * n_params * tokens + attn, {
        "dense_6NT": 6 * n_params * tokens, "causal_attention": attn}


def _split_step(cfg, pcfg, ocfg, state, batch) -> dict:
    """One more step of the same state, cut by CUDA events into the
    layers' forward, ``fused_xent`` forward and backward, the layers'
    backward (recomputing each layer under remat) and the clip with the
    optimizer; the same gradients ``make_train_step`` takes, in ms."""
    from repro_torch.models import transformer as T
    from repro_torch.models.lm_head import fused_xent
    from repro_torch.models.params import tree_leaves, tree_map, \
        tree_unflatten
    from repro_torch.training.optimizer import (clip_by_global_norm,
                                                make_optimizer)
    from repro_torch.training.train_step import AUX_WEIGHT

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    params = state["params"]
    paths = [p for p, _ in tree_leaves(params)]
    alias = tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = [t for _, t in tree_leaves(alias)]
    table = alias["embed"]["tok"]                       # tied
    ev[0].record()
    feats, aux = T.forward(cfg, pcfg, alias, batch, mode="features")
    ev[1].record()
    f = feats.detach().requires_grad_()
    nll, count = fused_xent(f, table, batch["labels"])
    total = nll / torch.clamp(count, min=1) + AUX_WEIGHT * aux
    ev[2].record()
    dfeats, dtable = torch.autograd.grad(total, (f, table))
    ev[3].record()
    flat = list(torch.autograd.grad(feats, leaves, grad_outputs=dfeats))
    flat[paths.index("embed/tok")] += dtable
    ev[4].record()
    grads = tree_unflatten(params, dict(zip(paths, flat)))
    grads, _ = clip_by_global_norm(grads, ocfg.grad_clip)
    make_optimizer(ocfg)[1](params, grads, state["opt"])
    ev[5].record()
    ev[5].synchronize()
    names = ("layers_forward_ms", "fused_xent_forward_ms",
             "fused_xent_backward_ms", "layers_backward_ms",
             "optimizer_ms")
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def _attention_ms(dev, cfg, b, s, chunk) -> dict:
    """One layer's ``chunked_attention`` at the training shapes (bf16 q
    (b, s, h, dh), k and v over the KV heads, causal, tiles of
    ``chunk``): forward ms and forward + backward ms (CUDA events), and
    ``scaled_dot_product_attention``'s forward + backward on the same
    inputs (a yardstick the port does not call)."""
    import torch.nn.functional as F
    from repro_torch.models.attention import chunked_attention

    g = torch.Generator(device=dev).manual_seed(19)
    h, kvh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v, do = (torch.randn(shape, generator=g, device=dev,
                               dtype=torch.bfloat16)
                   for shape in ((b, s, h, dh), (b, s, kvh, dh),
                                 (b, s, kvh, dh), (b, s, h, dh)))
    for t in (q, k, v):
        t.requires_grad_()

    def ours():
        return chunked_attention(q, k, v, causal=True, chunk_q=chunk,
                                 chunk_k=chunk)

    def sdpa():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)

    with torch.no_grad():
        fwd = time_ms(ours, iters=3, warmup=1)
    both = time_ms(lambda: torch.autograd.grad(ours(), (q, k, v), do),
                   iters=3, warmup=1)
    lib = time_ms(lambda: torch.autograd.grad(sdpa(), (q, k, v), do),
                  iters=3, warmup=1)
    return {"shape": [b, s, h, kvh, dh], "chunk": chunk,
            "chunked_forward_ms": fwd, "chunked_forward_backward_ms": both,
            "sdpa_forward_backward_ms": lib,
            # remat "full": each layer runs the forward twice
            "per_step_ms": cfg.num_layers * (fwd + both)}


def _profiled_step(step, state, batch) -> tuple:
    """One step under ``torch.profiler``: the card's busy ms by kernel
    group and the 12 kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    busy = _device_busy(prof)
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy["top_kernels"] = [[e.key[:100], e.self_device_time_total / 1e3,
                            e.count] for e in kernels[:12]]
    return state, busy


def train_full(dev) -> dict:
    """Phase 19(b): gemma-2b at full width and depth (18 layers, d_model
    2048, 8 query heads over 1 KV head of 256, d_ff 16384 geglu, a
    256 000-token tied vocab; 2.51 B parameters as float32 master
    weights from a seeded generator on the card), AdamW with float32
    state, remat "full", chunked attention in tiles of 512, the
    launcher's defaults, over ``SyntheticLM`` at batch 4 x 2048: 8 steps
    (warmup 2), the attention projections at their contraction's fan-in
    (``_attention_fan_in``; one step at the init rule's scales first
    prints its loss and gradient norm).  Every loss and grad norm
    finite, the mean of the last two losses below the first.  Printed: each step's ms (CUDA events),
    the median of steps 3-8 with tokens/s, peak memory, one more step
    split by parts (``_split_step``), a profiled step's busy time by
    kernel group and its top kernels, one layer's attention forward and
    backward beside SDPA's (``_attention_ms``), and the model FLOPs'
    share of the bf16 peak."""
    from repro_torch.configs import (ARCHS, OptimizerConfig, ParallelConfig,
                                     ShapeConfig)
    from repro_torch.data.pipeline import PipelineConfig, SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params, param_count
    from repro_torch.training.train_step import make_train_step

    cfg = ARCHS["gemma-2b"]
    b, s, n_steps = 4, 2048, 8
    pcfg = ParallelConfig(remat="full", attention_impl="chunked",
                          attention_chunk=512, moe_impl="dense")
    ocfg = OptimizerConfig(lr=3e-4, warmup_steps=2, total_steps=n_steps)
    data = SyntheticLM(cfg, ShapeConfig("t", s, b, "train"),
                       PipelineConfig(seed=1))
    defs = T.model_defs(cfg)
    n_params = param_count(defs)
    init, step = make_train_step(cfg, pcfg, ocfg)
    # one step at the init rule's scales, for its gradient norm
    state = init(init_params(defs, torch.Generator(device=dev).manual_seed(
        19), dev, torch.float32))
    state, m = step(state, _on(data.batch(0), dev))
    rule = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    del state, m
    _free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(defs, torch.Generator(device=dev).manual_seed(19),
                         dev, torch.float32)
    _attention_fan_in(params, cfg)
    state = init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    losses, gnorms, step_ms = [], [], []
    for i in range(n_steps):
        batch = _on(data.batch(i), dev)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        state, m = step(state, batch)
        e1.record()
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        step_ms.append(e0.elapsed_time(e1))
    peak = torch.cuda.max_memory_allocated(dev)
    split = _split_step(cfg, pcfg, ocfg, state, _on(data.batch(n_steps),
                                                     dev))
    state, profiled = _profiled_step(step, state,
                                     _on(data.batch(n_steps + 1), dev))
    med = float(np.median(step_ms[2:]))
    flops, counted = _model_flops(cfg, n_params, b, s)
    out = {"phase": "train_full", "arch": cfg.name,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": [cfg.num_heads, cfg.num_kv_heads],
           "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "params": n_params,
           "batch": [b, s], "optimizer": "adamw", "state_dtype": "float32",
           "remat": "full", "attention_chunk": 512, "init_seconds": init_s,
           "init_rule_first_step": rule, "attention_fan_in": True,
           "losses": losses, "grad_norms": gnorms, "step_ms": step_ms,
           "step_ms_median_3_8": med,
           "tokens_per_s": b * s / (med / 1e3),
           "peak_memory_gb": peak / 1e9,
           "split_ms": split, "split_sum_ms": sum(split.values()),
           "profiled_step": profiled,
           "model_flops": flops, "model_flops_counted": counted,
           "achieved_tflops": flops / (med / 1e3) / 1e12,
           "bf16_peak_share": flops / (med / 1e3) / BF16_FLOPS}
    del state, params, m, batch
    _free_card()
    out["attention"] = _attention_ms(dev, cfg, b, s, 512)
    _free_card()
    if not (all(np.isfinite(losses)) and all(np.isfinite(gnorms))
            and np.mean(losses[-2:]) < losses[0]):
        raise AssertionError(f"train_full: losses not finite and falling: "
                             f"{json.dumps(out)}")
    return out


def train_restart(dev) -> dict:
    """Phase 19(c), at (a)'s size in bf16 compute: a checkpoint of the
    train state written on the card reloads bit for bit (onto the
    card); a ``Supervisor`` run with a failure injected at step 3 and
    checkpoints every 2 resumes from step 2, and its losses equal an
    uninterrupted run's (bit for bit, or within ``RESTART_RTOL`` if the
    card's atomics part them); then the launcher itself,
    ``launch.train.main`` on the card with ``--fail-at 3 --ckpt-every
    2``, resumes from step 2."""
    import tempfile
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import (OptimizerConfig, ParallelConfig,
                                     ShapeConfig)
    from repro_torch.data.pipeline import PipelineConfig, SyntheticLM
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params, tree_leaves, tree_map
    from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                     Supervisor)
    from repro_torch.training.train_step import make_train_step

    cfg = _small_gemma()
    init, step = make_train_step(
        cfg, ParallelConfig(remat="full", attention_impl="chunked",
                            attention_chunk=64, moe_impl="dense"),
        OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=6))
    data = SyntheticLM(cfg, ShapeConfig("t", 128, 4, "train"),
                       PipelineConfig(seed=19))
    state0 = init(init_params(T.model_defs(cfg), torch.Generator(
        device=dev).manual_seed(19), dev))

    def step_fn(st, batch):
        return step(st, _on(batch, dev))

    with tempfile.TemporaryDirectory() as d:
        state, _ = Supervisor(Checkpointer(f"{d}/warm"), ckpt_every=2).run(
            tree_map(torch.clone, state0), step_fn, data.batch, 2)
        ck = Checkpointer(f"{d}/roundtrip")
        ck.save(2, state)
        back, _ = ck.load(state)
        pairs = list(zip(tree_leaves(back), tree_leaves(state)))
        roundtrip = all(x.device == y.device and same_bits(x, y)
                        for (_, x), (_, y) in pairs)
        _, clean = Supervisor(Checkpointer(f"{d}/clean"), ckpt_every=2).run(
            tree_map(torch.clone, state0), step_fn, data.batch, 6)
        _, ft = Supervisor(Checkpointer(f"{d}/ft"), ckpt_every=2,
                           injector=FailureInjector(fail_at=[3])).run(
            tree_map(torch.clone, state0), step_fn, data.batch, 6)
        rel = max(abs(ft.losses[k] - clean.losses[k]) / abs(clean.losses[k])
                  for k in clean.losses)
        launched = launch_train.main(
            ["--device", str(dev), "--reduced", "--width", "256", "--layers",
             "2", "--steps", "6", "--batch", "4", "--seq", "128",
             "--ckpt-every", "2", "--fail-at", "3", "--log-every", "2",
             "--ckpt-dir", f"{d}/launch"])
    out = {"phase": "train_restart", "arch": cfg.name,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "leaves": len(pairs), "checkpoint_bit_exact": roundtrip,
           "restarts": ft.restarts, "resumed_from": ft.resumed_from,
           "losses_bit_equal": ft.losses == clean.losses,
           "losses_max_rel_diff": rel, "losses": clean.losses,
           "launcher": {k: launched[k] for k in (
               "steps_run", "restarts", "resumed_from", "first_loss",
               "last_loss")}}
    del state0, state, back
    _free_card()
    if not (roundtrip and ft.restarts == 1 and ft.resumed_from == [2]
            and len(ft.losses) == 6 and rel <= RESTART_RTOL
            and launched["restarts"] == 1
            and launched["resumed_from"] == [2]
            and all(np.isfinite(list(launched["losses"].values())))):
        raise AssertionError(f"train_restart: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------- #
# Phases 20-21: tensor-parallel serving and data-parallel training over
# torch.distributed (one process per rank)
# ---------------------------------------------------------------------- #

# phase 20(b): minitron-8b's logits at two ranks against one process,
# both with wq x 0.01 (phase 6's cure for near-one-hot attention): the
# row-parallel sums add bf16 partials in another order in each of 32
# layers, and the logits are bf16 products (spacing 2**-5 at |logit| in
# [4, 8)); 0.094 (three such steps) measured on an H100
TP_LOGIT_ATOL = 0.1
# phase 20(b)'s eager prefill oracle over the ranks against the fused
# path in one process: the tensor-parallel reordering above plus the
# eager-against-fused difference phase 16 holds at LOGIT_ATOL (a naive
# attention in float32 softmax against the flash kernel's tiles)
TP_EAGER_LOGIT_ATOL = TP_LOGIT_ATOL + LOGIT_ATOL
# its K/V past layer 0, relative to the largest |value| of the layer
TP_ARENA_RTOL = 2 ** -5
# phase 21(a): the launcher's losses at two ranks against one: the first
# step's within float32 sums in another order; the later ones move with
# AdamW's eps=1e-8, whose first updates are about lr * sign(g), so a
# near-zero gradient component summed in another order moves by lr in
# one run only (tests/test_torch_data_parallel.py; 1.3e-4 relative at
# step 3 on the CPU at this size)
DP_FIRST_RTOL = 1e-5
DP_LOSS_RTOL = 1e-3
# phase 21(a): the CPU test's train step (tests/test_torch_data_parallel.py,
# AdamW's eps=1e-3, so an update does not turn on a gradient's sign) at
# two ranks against one: the grad norm at that test's GNORM_RTOL, the
# loss at DP_FIRST_RTOL (its LOSS_RTOL).  Only one step: its grad norm
# is 16 under the init rule, clipped to 1, and from there float32 sums
# in another order part the runs (on the CPU, the same batch again:
# 0.24% at step 2, 32% at step 3)
DP_GNORM_RTOL = 1e-4
# ... and every updated parameter within lr / 10: the CPU test holds
# 5e-6, but the card's float32 products sum in other orders than the
# CPU's (5.78e-6 measured on an H100); a rank whose gradient was not
# summed moves a sign-driven update by up to 2 lr (2e-3)
DP_UPDATE_ATOL = 1e-4
DP_SEQ = 2048          # phase 21(b): gemma-2b's global batch is 4 x DP_SEQ
# phase 21(b): what a rank process holds on the card beyond its
# allocator's reserved bytes (its CUDA context, the kernels' modules)
# and slack for the allocator's rounding past the probed depths
DP_RANK_OVERHEAD = 2e9
# phase 22: gemma-2b under ZeRO-3 against phase 21(b)'s replicated run at
# the same depth, on the same weights and batches: the first step's loss
# is the same forward (the gathers are exact), so DP_FIRST_RTOL; the
# grad norms sum the slices' squares over the ranks, DP_GNORM_RTOL; the
# later losses move with AdamW's eps=1e-8 as phase 21(a)'s do,
# DP_LOSS_RTOL; the parameter checksums (the float64 sum of ~1 B float32
# values, each moved by about lr a step) by the same sign flips, at
# DP_LOSS_RTOL too
ZERO_STEPS = 2
# what a ZeRO-3 rank holds a parameter beyond activations: float32
# weights, AdamW's m and v and the gradient, each a slice of two
ZERO_STATE_BYTES = 16 / 2
# phase 24: gemma-2b in the rule set's 2-D layout against phase 22(a)'s
# ZeRO-3 run, the same weights and batches, bf16 compute: the
# row-parallel products (attention's wo, the MLP's down projection) sum
# two bf16 partials where ZeRO-3 rounds one whole product, and the LM
# head merges its log-sum-exp over two vocab blocks.  On the CPU at
# width 256, 4 layers, 4 x 256 tokens (3 AdamW steps, eps 1e-8) the two
# layouts' losses part by 2.5e-5 and their grad norms by 3.7e-4
# relative; at full width the sums are longer and every step after the
# first also carries AdamW's sign flips (DP_LOSS_RTOL's reason), so the
# losses are held at DP_LOSS_RTOL and the grad norms at 1e-2 in every
# step both runs took
RULE_TRAIN_MESH = {"data": 2, "model": 2}
RULE_TRAIN_STEPS = 3
RULE_TRAIN_LOSS_RTOL = DP_LOSS_RTOL
RULE_TRAIN_GNORM_RTOL = 1e-2


def _recorder_class():
    """The engine with each choice's logits kept (on the device) and,
    given a reference's tokens, every choice taken from them (teacher
    forcing, so two runs see the same inputs)."""
    from repro_torch.serving.engine import PagedEngine

    class Recorder(PagedEngine):
        def __init__(self, *a, ref_tokens=None, **kw):
            super().__init__(*a, **kw)
            self.ref_tokens = ref_tokens
            self.logits, self.tokens = [], []

        def _choose(self, logits, temps, seed, rowmap=None):
            self.logits.append(logits.detach().float().clone())
            if self.ref_tokens is None:
                tok = super()._choose(logits, temps, seed, rowmap=rowmap)
            else:
                tok = self.ref_tokens[len(self.logits) - 1].to(
                    logits.device)
            self.tokens.append(tok.detach().clone())
            return tok

    return Recorder


def _drive(engine, reqs, snap_at=None, layers=None) -> dict:
    """``launch.serve.serve``'s loop on a given engine: one step a round,
    or a K-block when nothing waits; each step's host seconds (ending
    in a synchronise) and launch delta; after step ``snap_at`` a copy
    of the K/V arenas (``layers`` of them, on the device)."""
    for r in reqs:
        engine.submit(r)
    q = engine.cache.queue
    results, seconds, deltas, snap = {}, [], [], None
    t0 = time.perf_counter()
    while engine.has_work:
        rounds = (engine.decode_block_rounds
                  if engine.prefill_backlog_tokens() == 0 else 1)
        before = q.snapshot()
        t = time.perf_counter()
        results.update(engine.run(max_rounds=rounds))
        synchronize(engine.device)
        seconds.append(time.perf_counter() - t)
        deltas.append(q.delta(before))
        if snap_at is not None and len(seconds) == snap_at:
            sel = list(range(engine.cache.n_layers)) if layers is None \
                else list(layers)
            snap = [a[sel].clone() for a in (engine.cache.k_arena,
                                              engine.cache.v_arena)]
    total = time.perf_counter() - t0
    decode = [s for s, d in zip(seconds, deltas) if d == {"fused_decode": 1}]
    return {"results": results, "seconds": total, "step_seconds": seconds,
            "deltas": deltas, "arenas": snap,
            "tokens": sum(len(v) for v in results.values()),
            "decode_round_ms_median": (float(np.median(decode)) * 1e3
                                       if decode else None)}


def _margin_check(ours, ref, atol) -> dict:
    """Each choice's logits within ``atol`` of the reference's, and the
    margin rule: where the reference's top-1/top-2 gap exceeds twice
    ``atol`` our own argmax must be its token.  Returns the largest
    difference and the choices the margin decided (of all rows)."""
    if len(ours) != len(ref):
        raise AssertionError(f"{len(ours)} choices, the reference made "
                             f"{len(ref)}")
    worst, decided, rows = 0.0, 0, 0
    for a, b in zip(ours, ref):
        b = b.to(a.device)
        worst = max(worst, float((a - b).abs().max()))
        top2 = b.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * atol
        if not torch.equal(a.argmax(-1)[sure], b.argmax(-1)[sure]):
            raise AssertionError("a choice the margin decides differs")
        decided += int(sure.sum())
        rows += int(sure.numel())
    if worst > atol:
        raise AssertionError(f"logits differ by {worst} > {atol}")
    return {"max_abs_diff": worst, "margin_decided": decided,
            "choices": rows, "atol": atol,
            "max_abs_logit": max(float(b.abs().max()) for b in ref)}


def _peak_gb(dev) -> Optional[float]:
    return (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else None)


def tp_world1(dev, greedy, phase3_round_ms, card) -> tuple:
    """Phase 20(a): granite-3-8b at full width and depth, phase 3's
    greedy workload, served under ``mesh=make_local_mesh(model=1)`` over
    a one-rank NCCL group with the step graphs on (the vocab-parallel
    embedding and logits sums and both row-parallel sums captured in
    each graph): streams equal phase 3's bit for bit, the K/V arenas
    after step 2 equal a host-local engine's bit for bit, one
    ``fused_decode`` a round, owners ``{"kv"}``; then
    ``compressed_collectives=True``, teacher-forced by the host-local
    run, holds its logits within the int8 sum's bound (per choice, the
    row's largest |logit| / 127: a half-step in and a half-step out)
    and the margin rule."""
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.mesh import make_local_mesh, process_group
    from repro_torch.serving.engine import Request

    Recorder = _recorder_class()
    cfg, params, _ = granite_params(dev)
    kw = dict(page_size=16, num_pages=1024, device=dev)
    host_eng = Recorder(cfg, params, **kw)
    host = _drive(host_eng, granite_requests(cfg, Request), snap_at=2)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with process_group(backend):
        mesh = make_local_mesh(model=1)
        reset_launches()
        eng = Recorder(cfg, params, mesh=mesh, **kw)
        sharded = _drive(eng, granite_requests(cfg, Request), snap_at=2)
        counts = launch_counts()
        owners = eng.cache.queue.snapshot(by_owner=True)
        graphs = _graph_stats(eng)
        captured, due = eng._steps.captured, eng._steps.due
        del eng
        comp_eng = Recorder(cfg, params, mesh=mesh,
                            compressed_collectives=True,
                            ref_tokens=host_eng.tokens, **kw)
        comp = _drive(comp_eng, granite_requests(cfg, Request))
        bound_atol = max(float(b.abs().max()) for b in host_eng.logits) / 127
        compressed = _margin_check(comp_eng.logits, host_eng.logits,
                                   bound_atol)
        del comp_eng
    del host_eng
    same_arenas = all(torch.equal(a, b) for a, b in zip(sharded["arenas"],
                                                         host["arenas"]))
    one_a_round = all(d.get("fused_decode", 0) <= 1 for d in
                      sharded["deltas"])
    out = {"phase": "tp_world1", "nvidia_smi": card, "arch": cfg.name,
           "backend": backend, "mesh": {"data": 1, "model": 1},
           "streams_equal_phase3": sharded["results"] == greedy,
           "streams_equal_host_local": sharded["results"] == host["results"],
           "arenas_bit_equal_after_step_2": same_arenas,
           "decode_round_ms_median": sharded["decode_round_ms_median"],
           "phase3_decode_round_ms_median": phase3_round_ms,
           "host_local_decode_round_ms_median": host["decode_round_ms_median"],
           "tokens_per_s": sharded["tokens"] / sharded["seconds"],
           "fused_decode_once_a_round": one_a_round,
           "owners": sorted(owners), "graphs": graphs,
           "captured": captured, "due": due,
           "compressed": compressed,
           "compressed_streams_equal": comp["results"] == host["results"],
           "kernel_launches": counts}
    del params, host, sharded, comp
    _free_card()
    if not (out["streams_equal_phase3"] and out["streams_equal_host_local"]
            and same_arenas and one_a_round and out["owners"] == ["kv"]
            and (dev.type != "cuda" or (captured == due and captured > 0))):
        raise AssertionError(f"tp_world1: {json.dumps(out)}")
    if dev.type == "cuda":
        _check_launched(counts, PHASE3_KERNELS[:1] + PHASE3_KERNELS[2:],
                        "tp_world1")
    return out, counts


TP_SEED = 24
TP_REQS = dict(n=4, lo=64, hi=1025, new_tokens=16)
TP_CHUNKED = dict(max_prefill_chunk=256, mixed_rounds=True,
                  decode_block_rounds=8)


def _minitron(dev, cfg, mesh=None):
    """``cfg`` (minitron-8b at full width and depth), random bf16 weights
    from ``TP_SEED`` on the card (with a mesh: each leaf drawn in full
    and cut to this rank's block at once), ``wq`` x 0.01."""
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    gen = torch.Generator(device=dev).manual_seed(TP_SEED)
    params = init_params(T.model_defs(cfg), gen, dev, torch.bfloat16,
                         mesh=mesh)
    _scale_queries(params, 0.01)
    synchronize(dev)
    return params


def _tp_rank(rank: int, world: int, cfg, ref_path: str, device: str
             ) -> dict:
    """One rank of phase 20(b): minitron-8b's slice, both workloads
    teacher-forced by the one-process run saved at ``ref_path``, over
    the gloo group on the one card, graphs off."""
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.params import param_count
    from repro_torch.serving.engine import Request

    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_local_mesh(model=world)
    t0 = time.perf_counter()
    params = _minitron(dev, cfg, mesh)
    init_s = time.perf_counter() - t0
    local_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(params))
    ref = torch.load(ref_path, weights_only=False)
    Recorder = _recorder_class()
    kvh = cfg.num_kv_heads // world
    out = {"rank": rank, "init_seconds": init_s, "weight_bytes": local_bytes,
           "full_weight_bytes": param_count(T.model_defs(cfg)) * 2}
    reset_launches()
    for mode, kw in (("monolithic", {}), ("chunked", ref["chunked_kw"])):
        r = ref[mode]
        eng = Recorder(cfg, params, page_size=16, num_pages=512, device=dev,
                       mesh=mesh, cuda_graphs=False,
                       ref_tokens=[t.to(dev) for t in r["tokens"]], **kw)
        run = _drive(eng, seeded_requests(cfg, Request, **ref["reqs"]),
                     snap_at=2, layers=r["layers"])
        check = _margin_check(eng.logits, r["logits"], TP_LOGIT_ATOL)
        arenas = {}
        for name, ours, full in zip("kv", run["arenas"], r["arenas"]):
            want = full[..., rank * kvh:(rank + 1) * kvh, :].to(dev)
            arenas[name] = {
                "layer0_bit_equal": bool(torch.equal(ours[0], want[0])),
                "max_abs_diff": float((ours.float() - want.float()).abs()
                                      .max()),
                "max_rel_to_layer_absmax": max(
                    float((ours[i].float() - want[i].float()).abs().max()
                          / want[i].float().abs().max())
                    for i in range(1, ours.shape[0]))}
        argmax = [lg.argmax(-1).cpu() for lg in eng.logits]
        out[mode] = {
            "results": run["results"], "choices": check,
            "argmax": argmax,
            "logits_sum": [float(lg.double().sum()) for lg in eng.logits],
            "arenas": arenas, "deltas": run["deltas"],
            "owners": eng.cache.queue.snapshot(by_owner=True),
            "decode_round_ms_median": run["decode_round_ms_median"],
            "step_ms": [x * 1e3 for x in run["step_seconds"]],
            "tokens": run["tokens"], "seconds": run["seconds"],
            "stats": {k: eng.stats[k] for k in (
                "mixed_dispatches", "multi_round_blocks",
                "fused_dispatches")}}
        del eng
    # the eager prefill oracle on the rank's slices, one request at a
    # time, teacher-forced by the fused path's one-process run
    r = ref["eager"]
    eng = Recorder(cfg, params, page_size=16, num_pages=512, device=dev,
                   mesh=mesh, cuda_graphs=False, fused_prefill=False,
                   ref_tokens=[t.to(dev) for t in r["tokens"]])
    results, deltas = {}, []
    t = time.perf_counter()
    for req in seeded_requests(cfg, Request, **ref["reqs"]):
        run = _drive(eng, [req])
        results.update(run["results"])
        deltas += run["deltas"]
    out["eager"] = {
        "results": results, "deltas": deltas,
        "choices": _margin_check(eng.logits, r["logits"],
                                 TP_EAGER_LOGIT_ATOL),
        "logits_sum": [float(lg.double().sum()) for lg in eng.logits],
        "seconds": time.perf_counter() - t,
        "pages_in_use": eng.cache.pages_in_use}
    del eng
    out["kernel_launches"] = launch_counts()
    out["peak_gb"] = _peak_gb(dev)
    return out


def _leaves(tree):
    from repro_torch.models.params import tree_leaves
    return [t for _, t in tree_leaves(tree)]


def tp_world2(dev, card) -> tuple:
    """Phase 20(b): minitron-8b at full width and depth (32 layers,
    d_model 4096, 32/8 heads, d_ff 16384, vocab 256 000) served by two
    gloo ranks sharing the one card (graphs off: gloo's collectives run
    on the host), 4 greedy requests monolithic, then chunked (256) with
    mixed rounds and 8-round blocks, each teacher-forced by the same
    model served in this process first: logits within TP_LOGIT_ATOL and
    the margin rule, the ranks' logits and streams equal, each rank's
    K/V slice after step 2 equal to the one-process arenas' head slice
    (layer 0 bit for bit; layers 1 and 31 within TP_ARENA_RTOL of the
    layer's largest |value|), one dispatch a step and owners
    ``kv/shard0`` / ``kv/shard1``.  Then the eager prefill oracle
    (``fused_prefill=False``) on the ranks' slices, the 4 requests one
    at a time, teacher-forced by the fused path's one-process run of
    them: logits within TP_EAGER_LOGIT_ATOL and its margin rule, the
    ranks equal, no fused prefill launched.  Two ranks time-share the
    card and sum through host collectives: its ms are not a speed of
    tensor parallelism."""
    import tempfile
    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.serving.engine import Request

    Recorder = _recorder_class()
    t0 = time.perf_counter()
    cfg = ARCHS["minitron-8b"]
    params = _minitron(dev, cfg)
    init_s = time.perf_counter() - t0
    layers = (0, 1, cfg.num_layers - 1)
    # the ranks run this workload, teacher-forced by this run
    ref = {"reqs": TP_REQS, "chunked_kw": TP_CHUNKED}
    host = {}
    for mode, kw in (("monolithic", {}), ("chunked", TP_CHUNKED)):
        eng = Recorder(cfg, params, page_size=16, num_pages=512, device=dev,
                       **kw)
        run = _drive(eng, seeded_requests(cfg, Request, **TP_REQS),
                     snap_at=2, layers=layers)
        ref[mode] = {"tokens": [t.cpu() for t in eng.tokens],
                     "logits": [lg.cpu() for lg in eng.logits],
                     "arenas": [a.cpu() for a in run["arenas"]],
                     "layers": layers}
        host[mode] = {"results": run["results"], "deltas": run["deltas"],
                      "decode_round_ms_median": run["decode_round_ms_median"],
                      "tokens_per_s": run["tokens"] / run["seconds"]}
        del eng, run
    # the eager oracle's reference: the fused path, one request at a time
    eng = Recorder(cfg, params, page_size=16, num_pages=512, device=dev)
    results = {}
    for req in seeded_requests(cfg, Request, **TP_REQS):
        results.update(_drive(eng, [req])["results"])
    ref["eager"] = {"tokens": [t.cpu() for t in eng.tokens],
                    "logits": [lg.cpu() for lg in eng.logits]}
    host["eager"] = {"results": results}
    del eng
    del params
    _free_card()
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/reference.pt"
        torch.save(ref, path)
        t1 = time.perf_counter()
        ranks = run_ranks(_tp_rank, 2, backend="gloo",
                          args=(cfg, path, str(dev)), timeout=600.0)
        ranks_s = time.perf_counter() - t1
    out = {"phase": "tp_world2", "nvidia_smi": card, "arch": cfg.name,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": [cfg.num_heads, cfg.num_kv_heads], "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "backend": "gloo", "ranks_on_one_card": 2,
           "cuda_graphs": False, "host_init_seconds": init_s,
           "ranks_seconds": ranks_s,
           "note": ("two ranks time-share one card and sum through host "
                    "collectives (gloo): not a speed of tensor "
                    "parallelism")}
    ok = True
    for mode in ("monolithic", "chunked"):
        r0, r1 = ranks
        m0, m1 = r0[mode], r1[mode]
        same_ranks = (m0["results"] == m1["results"]
                      and m0["logits_sum"] == m1["logits_sum"]
                      and all(torch.equal(a, b) for a, b in
                              zip(m0["argmax"], m1["argmax"])))
        # each round one dispatch (a prefill step: one a length bucket)
        one = all(d.get(k, 0) <= 1 for d in m0["deltas"] for k in (
            "fused_decode", "fused_mixed", "fused_decode_block"))
        owners = sorted(m0["owners"])
        arenas_ok = all(
            a["layer0_bit_equal"]
            and a["max_rel_to_layer_absmax"] <= TP_ARENA_RTOL
            for r in ranks for a in r[mode]["arenas"].values())
        row = {"streams_equal_one_process": m0["results"] == host[mode][
                   "results"],
               "ranks_equal": same_ranks,
               "deltas_equal_one_process": m0["deltas"] == host[mode][
                   "deltas"],
               "one_fused_dispatch_a_step": one, "owners": owners,
               "choices": m0["choices"],
               "arenas": {f"rank{r['rank']}": r[mode]["arenas"]
                          for r in ranks},
               "decode_round_ms_median": m0["decode_round_ms_median"],
               "one_process_decode_round_ms_median": host[mode][
                   "decode_round_ms_median"],
               "tokens_per_s": m0["tokens"] / m0["seconds"],
               "one_process_tokens_per_s": host[mode]["tokens_per_s"],
               "step_ms": m0["step_ms"], "stats": m0["stats"]}
        out[mode] = row
        ok = ok and (row["streams_equal_one_process"] and same_ranks
                     and row["deltas_equal_one_process"] and one
                     and owners == ["kv/shard0", "kv/shard1"] and arenas_ok)
    e0, e1 = ranks[0]["eager"], ranks[1]["eager"]
    out["eager"] = {
        "fused_prefill": False, "one_request_at_a_time": True,
        "streams_equal_fused_one_process": e0["results"] == host["eager"][
            "results"],
        "ranks_equal": (e0["results"] == e1["results"]
                        and e0["logits_sum"] == e1["logits_sum"]),
        "no_fused_prefill": not any("fused_prefill" in d
                                    for d in e0["deltas"]),
        "choices": e0["choices"], "seconds": e0["seconds"],
        "pages_in_use": [e0["pages_in_use"], e1["pages_in_use"]]}
    ok = ok and all(out["eager"][k] for k in (
        "streams_equal_fused_one_process", "ranks_equal",
        "no_fused_prefill")) and out["eager"]["pages_in_use"] == [0, 0]
    out["chunked_ran_mixed_and_blocks"] = (
        out["chunked"]["stats"]["mixed_dispatches"] > 0
        and out["chunked"]["stats"]["multi_round_blocks"] > 0)
    out["rank_weight_gb"] = [r["weight_bytes"] / 1e9 for r in ranks]
    out["full_weight_gb"] = ranks[0]["full_weight_bytes"] / 1e9
    out["rank_init_seconds"] = [r["init_seconds"] for r in ranks]
    out["rank_peak_gb"] = [r["peak_gb"] for r in ranks]
    counts = ranks[0]["kernel_launches"]
    out["kernel_launches"] = counts
    _free_card()
    if not (ok and out["chunked_ran_mixed_and_blocks"]):
        raise AssertionError(f"tp_world2: {json.dumps(out, default=str)}")
    if dev.type == "cuda":
        _check_launched(counts, ("kv_scatter", "paged_attention",
                                 "flash_attention", "flash_attention_prefix",
                                 "page_init_batched"), "tp_world2")
    return out, counts


def _dp_steps(cfg, pcfg, ocfg, params, batches, dev, *, mesh=None,
              rank: int = 0, world: int = 1,
              keep_params: bool = False) -> dict:
    """Phase 21's train steps from ``params``, one a global batch of
    ``batches``, each on this rank's contiguous block of it: each step's
    loss, grad norm, a checksum of the parameters after it (the float64
    sum of every leaf) and its ms; the parameters after the last step
    (on the CPU) with ``keep_params``.  Under ``sharding_env(mesh,
    fsdp=True)`` (a ZeRO-3 rank, phase 22) the checksum is the whole
    leaves' and ``checksums_split`` this rank's slices' (the caller
    sums them over the ranks), beside the mesh's collective bytes over
    the steps."""
    from repro_torch.models.params import tree_leaves
    from repro_torch.training.train_step import make_train_step

    init, step = make_train_step(cfg, pcfg, ocfg, mesh=mesh)
    state = init(params)
    del params
    layout = step.layout
    out = {"losses": [], "grad_norms": [], "checksums": [], "step_ms": []}
    if layout is not None:
        out["checksums_split"] = []
        mesh.reset_collectives()
    for b in batches:
        per = b["tokens"].shape[0] // world
        b = {k: v[rank * per:(rank + 1) * per] for k, v in b.items()}
        synchronize(dev)
        t = time.perf_counter()
        state, m = step(state, _on(b, dev))
        synchronize(dev)
        out["step_ms"].append((time.perf_counter() - t) * 1e3)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        sums = [(k, float(t_.sum(dtype=torch.float64)))
                for k, t_ in tree_leaves(state["params"])]
        if layout is None:
            out["checksums"].append(sum(v for _, v in sums))
        else:
            # a rank's slices (summed over the ranks by the caller) and
            # the whole leaves (every rank's alike)
            out["checksums_split"].append(sum(
                v for k, v in sums if layout.dims[k] is not None))
            out["checksums"].append(sum(
                v for k, v in sums if layout.dims[k] is None))
    if layout is not None:
        out["collective_bytes"] = mesh.collective_bytes()
    if keep_params:
        out["params"] = {k: t_.cpu()
                         for k, t_ in tree_leaves(state["params"])}
    return out


def _dp_small(dev) -> tuple:
    """Phase 21(a)'s direct step, tests/test_torch_data_parallel.py's
    on the card: ``reduced(gemma-2b)`` at width 64, two layers, a
    512-token vocab, float32 weights drawn on the CPU from seed 0, one
    global batch of 4 x 32 from numpy's seed 0, AdamW lr 1e-3 eps 1e-3."""
    from repro_torch.configs import (ARCHS, OptimizerConfig, ParallelConfig,
                                     reduced)
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params, tree_map

    cfg = reduced(ARCHS["gemma-2b"], d_model=64, num_layers=2, d_ff=256,
                  vocab_size=512)
    params = tree_map(lambda t_: t_.to(dev), init_params(
        T.model_defs(cfg), torch.Generator().manual_seed(0), "cpu"))
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 33)).astype(np.int32)
    pcfg = ParallelConfig(remat="none", attention_impl="naive",
                          moe_impl="dense")
    ocfg = OptimizerConfig(lr=1e-3, eps=1e-3, warmup_steps=1,
                           total_steps=10)
    return (cfg, pcfg, ocfg, params,
            [{"tokens": toks[:, :-1], "labels": toks[:, 1:]}])


def _dp_gemma(cfg, dev, steps: int, mesh=None) -> tuple:
    """Phase 21(b)'s run: gemma-2b (``cfg`` cut in depth), float32
    master weights (attention at its fan-in, as phase 19), remat full,
    chunked attention, AdamW, ``steps`` global batches of 4 x DP_SEQ
    from ``SyntheticLM``.  With ``mesh`` (inside ``sharding_env(mesh,
    fsdp=True)``, phase 22) each leaf is drawn whole and cut to this
    rank's ZeRO-3 slice at once: the same weights, never whole on the
    card."""
    from repro_torch.configs import (OptimizerConfig, ParallelConfig,
                                     ShapeConfig)
    from repro_torch.data.pipeline import PipelineConfig, SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    params = init_params(T.model_defs(cfg), torch.Generator(
        device=dev).manual_seed(19), dev, torch.float32, mesh=mesh)
    _attention_fan_in(params, cfg)
    pcfg = ParallelConfig(remat="full", attention_impl="chunked",
                          attention_chunk=512, moe_impl="dense")
    ocfg = OptimizerConfig(lr=3e-4, warmup_steps=2, total_steps=steps)
    data = SyntheticLM(cfg, ShapeConfig("t", DP_SEQ, 4, "train"),
                       PipelineConfig(seed=1))
    return pcfg, ocfg, params, [data.batch(i) for i in range(steps)]


def _dp_rank(rank: int, world: int, gemma_cfg, steps: int,
             device: str) -> dict:
    """One rank of phase 21(a) and (b): the direct step of
    :func:`_dp_small`, then gemma-2b at full width cut to ``gemma_cfg``'s
    depth, each rank on its block of the global batch, gradients summed
    over the gloo group each step."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.params import param_count

    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_local_mesh(data=world)
    cfg, pcfg, ocfg, params, batches = _dp_small(dev)
    small = _dp_steps(cfg, pcfg, ocfg, params, batches, dev, mesh=mesh,
                      rank=rank, world=world, keep_params=True)
    del params
    _free_card()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    pcfg, ocfg, params, batches = _dp_gemma(gemma_cfg, dev, steps)
    big = _dp_steps(gemma_cfg, pcfg, ocfg, params, batches, dev, mesh=mesh,
                    rank=rank, world=world)
    big["params"] = param_count(T.model_defs(gemma_cfg))
    big["peak_gb"] = _peak_gb(dev)
    big["peak_reserved_gb"] = (torch.cuda.max_memory_reserved(dev) / 1e9
                               if dev.type == "cuda" else None)
    return {"small": small, "gemma": big}


def _dp_probe_rank(rank: int, world: int, cfg, device: str,
                   zero: bool = False) -> list:
    """The rank of :func:`_dp_probe`: its first train step of a two-rank
    run (its block, 2 x DP_SEQ, of the global batch) at one and at two
    layers, the allocator's peak reserved bytes of each (0 on the CPU).
    Replicated (phase 21(b)): rank 0 alone, through a one-rank gloo
    group, so the sync's flat buffer is held too; ``zero`` (phase 22):
    both ranks under ``sharding_env(mesh, fsdp=True)``."""
    from repro_torch.distributed.sharding import sharding_env
    from repro_torch.launch.mesh import make_local_mesh

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_local_mesh(data=world)
    if cuda:
        # the allocator's statistics exist once it has served a tensor
        torch.ones(1, device=dev)
    peaks = []
    for n in (1, 2):
        c = dataclasses.replace(cfg, num_layers=n)
        _free_card()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_reserved(dev) if cuda else 0
        with (sharding_env(mesh, fsdp=True) if zero
              else contextlib.nullcontext()):
            pcfg, ocfg, params, batches = _dp_gemma(
                c, dev, 1, mesh=mesh if zero else None)
            _dp_steps(c, pcfg, ocfg, params, batches, dev, mesh=mesh,
                      rank=rank, world=2)
        del params
        peaks.append(torch.cuda.max_memory_reserved(dev) - before
                     if cuda else 0)
    return peaks


def _dp_probe(cfg, dev, zero: bool = False) -> dict:
    """Phase 21(b)'s (and, with ``zero``, phase 22's) depth from a
    measurement: :func:`_dp_probe_rank` in fresh processes, as each
    rank starts (one for the replicated layout, both ranks for ZeRO-3);
    a rank then needs about ``base + layers x per_layer`` bytes (the
    larger rank's)."""
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import transformer as T
    from repro_torch.models.params import param_count

    peaks = run_ranks(_dp_probe_rank, 2 if zero else 1, backend="gloo",
                      args=(cfg, str(dev), zero), timeout=300.0)
    one, two = max(p[0] for p in peaks), max(p[1] for p in peaks)
    # a layer holds at least its training state: 20 bytes a parameter
    # replicated (float32 weights, gradients, AdamW m and v, the sync's
    # buffer), ZERO_STATE_BYTES a rank under ZeRO-3
    state = (ZERO_STATE_BYTES if zero else 20) * (
        param_count(T.model_defs(dataclasses.replace(cfg, num_layers=2)))
        - param_count(T.model_defs(dataclasses.replace(cfg,
                                                       num_layers=1))))
    per_layer = max(two - one, state)
    return {"peak_reserved_bytes": {"1": one, "2": two},
            "layer_state_bytes": state, "per_layer_bytes": per_layer,
            "base_bytes": one - per_layer}


def _compress_rank(rank: int, world: int, grads, device: str) -> dict:
    """One rank of phase 21(c): its gradient tree (CUDA tensors) through
    ``compressed_grad_sync`` over the gloo group."""
    from repro_torch.distributed.compression import compressed_grad_sync
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(data=world)
    tree = {k: v.to(device) for k, v in grads[rank].items()}
    out = compressed_grad_sync(tree, mesh, "data")
    return {k: v.cpu() for k, v in out.items()}


def _cpu_psum_compressed(stacked: torch.Tensor) -> torch.Tensor:
    """The quantization formula on the CPU: every rank's segments
    quantized, every rank's copy of segment r dequantized and summed in
    float32, re-quantized, dequantized (``stacked``: (world, ...))."""
    from repro_torch.distributed.compression import _dequantize, _quantize

    world = stacked.shape[0]
    flat = stacked.reshape(world, -1).float()
    n = flat.shape[1]
    seg = -(-n // world)
    flat = torch.nn.functional.pad(flat, (0, seg * world - n))
    codes, scale = _quantize(flat.reshape(world, world, seg))
    deq = _dequantize(codes, scale, seg)          # (rank, segment, seg)
    mine = deq.transpose(0, 1).sum(dim=1)         # (segment, seg)
    codes_r, scale_r = _quantize(mine)
    return _dequantize(codes_r, scale_r, seg).reshape(-1)[:n].reshape(
        stacked.shape[1:])


def dp_training(dev, card) -> dict:
    """Phase 21: (a) ``launch.train.main --data-axis 2 --backend gloo``
    at phase 19(a)'s size on the card against one process on the same
    global batch (first step within DP_FIRST_RTOL, later steps within
    DP_LOSS_RTOL), and the CPU test's train step on the card, two gloo
    ranks against one process: the loss (DP_FIRST_RTOL), the grad norm
    (DP_GNORM_RTOL), every updated parameter (DP_UPDATE_ATOL), the
    ranks' grad norms and parameters bit for bit; (b) gemma-2b at
    full width over two gloo ranks on the card, the depth cut so two
    replicated copies of its training state fit (sized from a one-rank
    step probed at one and two layers in a fresh process; printed with
    the bytes), the
    ranks' losses, grad norms and parameter checksums equal; (c)
    ``compressed_grad_sync`` on CUDA tensors at world 1 over NCCL and
    world 2 over gloo, against the quantization formula on the CPU, bit
    for bit."""
    import tempfile
    from repro_torch.configs import ARCHS
    from repro_torch.distributed.compression import compressed_grad_sync
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import (make_local_mesh, process_group,
                                         run_ranks)
    from repro_torch.models import transformer as T
    from repro_torch.models.params import param_count

    out = {"phase": "dp_training", "nvidia_smi": card}
    small = ["--device", str(dev), "--reduced", "--width", "256", "--layers",
             "2", "--steps", "3", "--batch", "4", "--seq", "128",
             "--log-every", "100"]
    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        one = launch_train.main(small + ["--ckpt-dir", f"{d}/one"])
        one_s = time.perf_counter() - t
        t = time.perf_counter()
        two = launch_train.main(small + ["--data-axis", "2", "--backend",
                                         "gloo", "--rank-timeout", "300",
                                         "--ckpt-dir", f"{d}/two"])
        two_s = time.perf_counter() - t
    rel = [abs(two["losses"][s] - one["losses"][s]) / abs(one["losses"][s])
           for s in sorted(one["losses"])]
    out["launcher"] = {"one_rank_losses": one["losses"],
                       "two_rank_losses": two["losses"], "rel_diff": rel,
                       "one_rank_seconds": one_s, "two_rank_seconds": two_s}
    launcher_ok = (sorted(two["losses"]) == sorted(one["losses"])
                   and rel[0] <= DP_FIRST_RTOL
                   and max(rel) <= DP_LOSS_RTOL)
    # (a) the direct step's one-process run, on the global batch
    cfg_s, pcfg_s, ocfg_s, params_s, batches_s = _dp_small(dev)
    ref = _dp_steps(cfg_s, pcfg_s, ocfg_s, params_s, batches_s, dev,
                    keep_params=True)
    del params_s

    # (b) the depth that fits: two ranks, each about base + layers x
    # per_layer bytes (probed), within the free bytes less each rank's
    # overhead
    cfg = ARCHS["gemma-2b"]
    probe = _dp_probe(cfg, dev)
    free = torch.cuda.mem_get_info(dev)[0]
    budget = free / 2 - DP_RANK_OVERHEAD
    layers = int(min(cfg.num_layers, (budget - probe["base_bytes"])
                     // probe["per_layer_bytes"]))
    if layers < 1:
        raise AssertionError(f"dp_training: {free} free bytes hold no "
                             "layer's two replicated training states")
    p1 = param_count(T.model_defs(dataclasses.replace(cfg, num_layers=1)))
    p2 = param_count(T.model_defs(dataclasses.replace(cfg, num_layers=2)))
    per_layer, embed = p2 - p1, p1 - (p2 - p1)
    t = time.perf_counter()
    ranks = run_ranks(_dp_rank, 2, backend="gloo",
                      args=(dataclasses.replace(cfg, num_layers=layers), 3,
                            str(dev)), timeout=600.0)
    seconds = time.perf_counter() - t

    smalls = [r["small"] for r in ranks]
    gn_rel = [abs(g - w) / w for g, w in zip(smalls[0]["grad_norms"],
                                              ref["grad_norms"])]
    loss_rel = [abs(g - w) / abs(w) for g, w in zip(smalls[0]["losses"],
                                                     ref["losses"])]
    upd = max(float((smalls[0]["params"][k] - w).abs().max())
              for k, w in ref["params"].items())
    steps_ok = {
        "loss_rel_diff": loss_rel, "grad_norm_rel_diff": gn_rel,
        "param_max_abs_diff": upd,
        "ranks_equal": (smalls[0]["grad_norms"] == smalls[1]["grad_norms"]
                        and smalls[0]["checksums"] == smalls[1]["checksums"]
                        and all(torch.equal(smalls[0]["params"][k],
                                            smalls[1]["params"][k])
                                for k in ref["params"])),
        "grad_norm_rtol": DP_GNORM_RTOL, "update_atol": DP_UPDATE_ATOL,
        "loss_rtol": DP_FIRST_RTOL}
    out["train_steps"] = steps_ok
    steps_pass = (steps_ok["ranks_equal"] and max(loss_rel) <= DP_FIRST_RTOL
                  and max(gn_rel) <= DP_GNORM_RTOL and upd <= DP_UPDATE_ATOL)

    g = [r["gemma"] for r in ranks]
    full = {"layers": layers, "of_layers": cfg.num_layers,
            "params": g[0]["params"], "probe": probe,
            "free_bytes_before": free,
            "budget_bytes_per_rank": budget,
            "rank_overhead_bytes": DP_RANK_OVERHEAD,
            "state_bytes_per_rank": 20 * (embed + layers * per_layer),
            "full_depth_state_bytes_two_ranks": 2 * 20 * (
                embed + cfg.num_layers * per_layer),
            "batch": [4, DP_SEQ], "losses": g[0]["losses"],
            "grad_norms": g[0]["grad_norms"],
            "checksums": g[0]["checksums"],
            "ranks_equal": all(g[0][k] == g[1][k] for k in (
                "losses", "grad_norms", "checksums")),
            "step_ms": g[0]["step_ms"],
            "peak_gb": [r["peak_gb"] for r in g],
            "peak_reserved_gb": [r["peak_reserved_gb"] for r in g],
            "seconds": seconds}
    out["gemma_2b_full_width"] = full
    full_ok = (full["ranks_equal"] and layers >= 1
               and all(np.isfinite(full["losses"]))
               and all(np.isfinite(full["grad_norms"])))

    # (c) compressed_grad_sync on the card against the CPU formula
    gen = torch.Generator().manual_seed(21)
    shapes = {"w": (64, 300), "b": (1000,), "z": (256,)}

    def tree():
        t_ = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
        t_["z"].zero_()
        return t_

    comp = {}
    g1 = tree()
    with process_group("nccl" if dev.type == "cuda" else "gloo"):
        mesh = make_local_mesh(data=1)
        got = compressed_grad_sync({k: v.to(dev) for k, v in g1.items()},
                                   mesh, "data")
        comp["world1_nccl_bit_equal"] = all(
            torch.equal(got[k].cpu(), _cpu_psum_compressed(g1[k][None]))
            for k in shapes)
    g2 = [tree(), tree()]
    res = run_ranks(_compress_rank, 2, backend="gloo", args=(g2, str(dev)),
                    timeout=180.0)
    comp["world2_gloo_bit_equal"] = all(
        torch.equal(r[k], _cpu_psum_compressed(
            torch.stack([g[k] for g in g2]))) for r in res for k in shapes)
    comp["zero_leaf_exact"] = all(not r["z"].any() for r in res)
    out["compressed_grad_sync"] = comp
    _free_card()
    if not (launcher_ok and steps_pass and full_ok and all(
            comp[k] for k in ("world1_nccl_bit_equal",
                              "world2_gloo_bit_equal", "zero_leaf_exact"))):
        raise AssertionError(f"dp_training: {json.dumps(out, default=str)}")
    return out


def _zero_rank(rank: int, world: int, cfg, steps: int, device: str
               ) -> dict:
    """One rank of phase 22: gemma-2b at full width cut to ``cfg``'s
    depth under ``sharding_env(mesh, fsdp=True)``: the slices drawn leaf
    by leaf from phase 21(b)'s seed, ``steps`` steps of phase 21(b)'s
    batches on this rank's block; its peak bytes measured over the
    steps only."""
    from repro_torch.distributed.sharding import sharding_env
    from repro_torch.launch.mesh import make_local_mesh

    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_local_mesh(data=world)
    with sharding_env(mesh, fsdp=True):
        t = time.perf_counter()
        pcfg, ocfg, params, batches = _dp_gemma(cfg, dev, steps, mesh=mesh)
        init_s = time.perf_counter() - t
        _free_card()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        out = _dp_steps(cfg, pcfg, ocfg, params, batches, dev, mesh=mesh,
                        rank=rank, world=world)
    out["init_seconds"] = init_s
    out["peak_gb"] = _peak_gb(dev)
    out["peak_reserved_gb"] = (torch.cuda.max_memory_reserved(dev) / 1e9
                               if dev.type == "cuda" else None)
    return out


def _zero_run(cfg, dev) -> dict:
    """Two ZeRO-3 ranks of phase 22 at ``cfg``'s depth, put together:
    rank 0's losses and grad norms, the checksum over both ranks'
    slices and the whole leaves, each rank's peak bytes."""
    from repro_torch.launch.mesh import run_ranks

    t = time.perf_counter()
    ranks = run_ranks(_zero_rank, 2, backend="gloo",
                      args=(cfg, ZERO_STEPS, str(dev)), timeout=900.0)
    r0, r1 = ranks
    return {"layers": cfg.num_layers, "losses": r0["losses"],
            "grad_norms": r0["grad_norms"],
            "checksums": [a + b + w for a, b, w in zip(
                r0["checksums_split"], r1["checksums_split"],
                r0["checksums"])],
            "ranks_equal": all(r0[k] == r1[k] for k in (
                "losses", "grad_norms", "checksums")),
            "step_ms": r0["step_ms"],
            "init_seconds": [r["init_seconds"] for r in ranks],
            "peak_gb": [r["peak_gb"] for r in ranks],
            "peak_reserved_gb": [r["peak_reserved_gb"] for r in ranks],
            "collective_bytes": r0["collective_bytes"],
            "seconds": time.perf_counter() - t}


def zero_training(dev, card, dp: dict) -> dict:
    """Phase 22: gemma-2b at full width under the JAX launcher's ZeRO-3
    layout (``sharding_env(mesh, fsdp=True)``) over two gloo ranks on
    the card, each holding its slices of the float32 weights and AdamW's
    moments.  (a) At phase 21(b)'s depth, ZERO_STEPS steps held against
    phase 21(b)'s replicated run of the same weights and batches
    (losses, grad norms, parameter checksums; see the tolerances above),
    the peak GB reserved a rank beside phase 21(b)'s; (b) the deepest
    depth a probe allows (two ZeRO-3 ranks at one and two layers, as
    phase 21(b) probes its one), ZERO_STEPS steps, finite, the ranks
    equal.  Two ranks time-share the card and gather through the host
    (gloo): the step ms are not a speed of ZeRO-3."""
    from repro_torch.configs import ARCHS

    ref = dp["gemma_2b_full_width"]
    cfg = ARCHS["gemma-2b"]
    t0 = time.perf_counter()
    same = _zero_run(dataclasses.replace(cfg, num_layers=ref["layers"]),
                     dev)
    n = ZERO_STEPS

    def rel(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(a[:n], b[:n])]

    held = {"loss_rel_diff": rel(same["losses"], ref["losses"]),
            "grad_norm_rel_diff": rel(same["grad_norms"],
                                      ref["grad_norms"]),
            "checksum_rel_diff": rel(same["checksums"], ref["checksums"]),
            "replicated_losses": ref["losses"][:n],
            "replicated_grad_norms": ref["grad_norms"][:n],
            "replicated_peak_reserved_gb": ref["peak_reserved_gb"]}
    same_ok = (same["ranks_equal"]
               and held["loss_rel_diff"][0] <= DP_FIRST_RTOL
               and max(held["loss_rel_diff"]) <= DP_LOSS_RTOL
               and max(held["grad_norm_rel_diff"]) <= DP_GNORM_RTOL
               and max(held["checksum_rel_diff"]) <= DP_LOSS_RTOL)
    _free_card()
    probe = _dp_probe(cfg, dev, zero=True)
    free = torch.cuda.mem_get_info(dev)[0] if dev.type == "cuda" else 0
    budget = free / 2 - DP_RANK_OVERHEAD
    layers = int(min(cfg.num_layers, (budget - probe["base_bytes"])
                     // probe["per_layer_bytes"])) if dev.type == "cuda" \
        else cfg.num_layers
    if layers < ref["layers"]:
        raise AssertionError(f"zero_training: the probe allows {layers} "
                             f"layers, fewer than phase 21(b)'s "
                             f"{ref['layers']}")
    deep = _zero_run(dataclasses.replace(cfg, num_layers=layers), dev)
    deep_ok = (deep["ranks_equal"] and all(np.isfinite(deep["losses"]))
               and all(np.isfinite(deep["grad_norms"])))
    out = {"phase": "zero_training", "nvidia_smi": card,
           "arch": cfg.name, "of_layers": cfg.num_layers,
           "layout": "sharding_env(mesh, fsdp=True): ZeRO-3 over data=2",
           "backend": "gloo", "ranks_on_one_card": 2,
           "batch": [4, DP_SEQ], "steps": n,
           "at_phase21_depth": dict(same, held=held),
           "probe": probe, "free_bytes_before": free,
           "budget_bytes_per_rank": budget, "deepest": deep,
           "seconds": time.perf_counter() - t0,
           "note": ("two ranks time-share one card and gather through "
                    "host collectives (gloo): not a speed of ZeRO-3")}
    _free_card()
    if not (same_ok and deep_ok):
        raise AssertionError(f"zero_training: {json.dumps(out, default=str)}")
    return out


def _rule_train_rank(rank: int, world: int, cfg, steps: int, device: str
                     ) -> dict:
    """One rank of phase 24: gemma-2b at full width cut to ``cfg``'s
    depth in the rule set's 2-D layout on ``RULE_TRAIN_MESH``: its blocks
    drawn leaf by leaf from phase 21(b)'s seed (the whole leaf drawn,
    this rank's block kept: phase 22's weights), ``steps`` steps of
    phase 21(b)'s batches on its block (rows over ``data``, the same on
    both ``model`` ranks); its losses, grad norms, step ms, the float64
    sum of its parameter blocks each divided by the ranks holding a
    copy of it (the ranks' sums add up to the whole parameters'), its
    peak bytes over the steps and its collective bytes by kind."""
    from repro_torch.distributed.sharding import sharding_env
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.params import tree_leaves
    from repro_torch.training.train_step import make_train_step

    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = Mesh(RULE_TRAIN_MESH)
    t = time.perf_counter()
    with sharding_env(mesh, fsdp=True):
        pcfg, ocfg, params, batches = _dp_gemma(cfg, dev, steps, mesh=mesh)
    rules = T.rule_layout(cfg, mesh)
    init, step = make_train_step(cfg, pcfg, ocfg, rules=rules)
    state = init(params)
    del params
    init_s = time.perf_counter() - t
    layout = step.layout
    copies = {p: world // layout.size(layout.axes(p))
              for p in layout.specs}
    _free_card()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    mesh.reset_collectives()
    out = {"losses": [], "grad_norms": [], "checksums": [], "step_ms": []}
    for b in batches:
        mine = rules.cut_batch(_on(b, dev))
        synchronize(dev)
        t = time.perf_counter()
        state, m = step(state, mine)
        synchronize(dev)
        out["step_ms"].append((time.perf_counter() - t) * 1e3)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        out["checksums"].append(sum(
            float(t_.sum(dtype=torch.float64)) / copies[k]
            for k, t_ in tree_leaves(state["params"])))
    out["collective_bytes"] = mesh.collective_bytes()
    out["coords"] = {a: mesh.index(a) for a in RULE_TRAIN_MESH}
    out["init_seconds"] = init_s
    out["peak_gb"] = _peak_gb(dev)
    out["peak_reserved_gb"] = (torch.cuda.max_memory_reserved(dev) / 1e9
                               if dev.type == "cuda" else None)
    return out


def rule_training(dev, card, zero: dict) -> dict:
    """Phase 24: gemma-2b at full width in the JAX rule set's 2-D
    training layout (``make_train_step(rules=transformer.rule_layout(
    cfg, mesh))``) on four gloo ranks at ``RULE_TRAIN_MESH``: its 8 heads
    and 16 384-wide MLP split over ``model``, its one KV head whole, its
    256 000-token vocab split; FSDP over ``data``.  Phase 22(a)'s depth,
    weights and global batch (4 x DP_SEQ), ``RULE_TRAIN_STEPS`` steps:
    the losses and grad norms against 22(a)'s ZeRO-3 run at
    ``RULE_TRAIN_*_RTOL``, every rank's equal, the parameter checksum
    (every block once) finite; each rank's peak GB reserved beside
    22(a)'s and its collective bytes by kind.  Four ranks time-share
    the card and reduce through the host (gloo): the step ms are not a
    speed of the layout."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import run_ranks

    ref = zero["at_phase21_depth"]
    cfg = dataclasses.replace(ARCHS["gemma-2b"], num_layers=ref["layers"])
    t0 = time.perf_counter()
    world = int(np.prod(list(RULE_TRAIN_MESH.values())))
    ranks = run_ranks(_rule_train_rank, world, backend="gloo",
                      args=(cfg, RULE_TRAIN_STEPS, str(dev)), timeout=600.0)
    r0 = ranks[0]
    n = min(len(ref["losses"]), RULE_TRAIN_STEPS)

    def rel(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(a[:n], b[:n])]

    held = {"loss_rel_diff": rel(r0["losses"], ref["losses"]),
            "grad_norm_rel_diff": rel(r0["grad_norms"], ref["grad_norms"]),
            "zero3_losses": ref["losses"][:n],
            "zero3_grad_norms": ref["grad_norms"][:n],
            "zero3_peak_reserved_gb": ref["peak_reserved_gb"],
            "loss_rtol": RULE_TRAIN_LOSS_RTOL,
            "grad_norm_rtol": RULE_TRAIN_GNORM_RTOL}
    ranks_equal = all(r[k] == r0[k] for r in ranks
                      for k in ("losses", "grad_norms"))
    checksum = [sum(c) for c in zip(*(r["checksums"] for r in ranks))]
    ok = (ranks_equal and all(np.isfinite(checksum))
          and all(np.isfinite(r0["losses"]))
          and max(held["loss_rel_diff"]) <= RULE_TRAIN_LOSS_RTOL
          and max(held["grad_norm_rel_diff"]) <= RULE_TRAIN_GNORM_RTOL)
    out = {"phase": "rule_training", "nvidia_smi": card,
           "arch": cfg.name, "layers": cfg.num_layers,
           "layout": "rules: TP over model x FSDP over data",
           "mesh": RULE_TRAIN_MESH, "backend": "gloo",
           "ranks_on_one_card": world, "batch": [4, DP_SEQ],
           "steps": RULE_TRAIN_STEPS, "losses": r0["losses"],
           "grad_norms": r0["grad_norms"], "checksums": checksum,
           "ranks_equal": ranks_equal, "held": held,
           "step_ms": r0["step_ms"],
           "init_seconds": [r["init_seconds"] for r in ranks],
           "peak_gb": [r["peak_gb"] for r in ranks],
           "peak_reserved_gb": [r["peak_reserved_gb"] for r in ranks],
           "collective_bytes": {json.dumps(r["coords"]): r["collective_bytes"]
                                for r in ranks},
           "seconds": time.perf_counter() - t0,
           "note": ("four ranks time-share one card and reduce through "
                    "host collectives (gloo): not a speed of the layout")}
    _free_card()
    if not ok:
        raise AssertionError(f"rule_training: {json.dumps(out, default=str)}")
    return out


# (arch, shape, the model axis set by hand, or None for the layout the
# sweep plans: the rule set's on JAX's mesh): a train cell at model 1 is
# ZeRO-3, a serving cell at 8 the engine's tensor-parallel step
DRYRUN_CELLS = (("gemma-2b", "train_4k", 1),
                ("gemma-2b", "train_4k", None),
                ("minitron-8b", "decode_32k", 8),
                ("granite-3-8b", "decode_32k", None),
                ("llama4-scout-17b-a16e", "decode_32k", None))


def dryrun_phase(dev, card) -> dict:
    """Phase 23: each of ``DRYRUN_CELLS`` traced on the card as rank 0
    (``launch.dryrun.trace_cell``) and on meta tensors; the card's run
    must fit, time its step and count the meta trace's flops and
    collective bytes."""
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.launch import dryrun as D
    out = {"phase": "dryrun", "torch": torch.__version__,
           "nvidia_smi": card, "cells": []}
    for arch, shape, model in DRYRUN_CELLS:
        cfg, sh = ARCHS[arch], SHAPES[shape]
        meta = D.trace_cell(cfg, sh, multi_pod=False, device="meta",
                            model=model)
        rec = D.trace_cell(cfg, sh, multi_pod=False, device=dev,
                           model=model)
        what = f"{arch} {shape}"
        if "unsupported" in rec or "unsupported" in meta:
            raise AssertionError(f"{what}: {rec.get('unsupported')} / "
                                 f"{meta.get('unsupported')}")
        mem, roof = rec["memory"], rec["roofline"]
        if not mem.get("fits_hbm_measured"):
            raise AssertionError(f"{what} did not fit the card: {mem}")
        if rec["traced"]["flops"] != meta["traced"]["flops"] \
                or rec["collectives"] != meta["collectives"]:
            raise AssertionError(f"{what}: card {rec['traced']} "
                                 f"{rec['collectives']}, meta "
                                 f"{meta['traced']} {meta['collectives']}")
        if not (rec["step_ms"] > 0 and np.isfinite(rec["step_ms"])
                and mem["peak_bytes_per_device"] >= mem["argument_bytes"]):
            raise AssertionError(f"{what}: step {rec['step_ms']} ms, "
                                 f"memory {mem}")
        t_bound = max(roof["t_compute_s"], roof["t_memory_s"])
        out["cells"].append({
            "arch": arch, "shape": shape, "layout": rec["layout"],
            "rank_mesh": rec["rank_mesh"], "batch_local": rec["batch_local"],
            "microbatches": rec["microbatches"],
            "attention_chunk": rec["attention_chunk"],
            "peak_bytes": mem["peak_bytes_per_device"],
            "peak_reserved_bytes": mem["peak_reserved_bytes"],
            "baseline_bytes": mem["baseline_bytes"],
            "baseline_reserved_bytes": mem["baseline_reserved_bytes"],
            "argument_bytes": mem["argument_bytes"],
            "argument_gb": mem["argument_bytes"] / 1e9,
            "peak_gb": mem["peak_bytes_per_device"] / 1e9,
            "peak_reserved_gb": mem["peak_reserved_bytes"] / 1e9,
            "card_equals_meta": True,
            "analytic_bytes": mem["analytic_bytes_per_device"],
            "hbm_bytes": mem["hbm_bytes"],
            "step_ms": rec["step_ms"],
            "t_compute_ms": roof["t_compute_s"] * 1e3,
            "t_memory_ms": roof["t_memory_s"] * 1e3,
            "t_bound_ms": t_bound * 1e3,
            "step_over_bound": rec["step_ms"] / (t_bound * 1e3),
            "bottleneck": roof["bottleneck"],
            "flops": rec["traced"]["flops"],
            "meta_flops": meta["traced"]["flops"],
            "bytes": rec["traced"]["bytes"],
            "meta_bytes": meta["traced"]["bytes"],
            "aten_ops": rec["traced"]["aten_ops"],
            "collectives": rec["collectives"],
            "collective_counts": rec["collective_counts"],
            "trace_s": rec["trace_s"], "meta_trace_s": meta["trace_s"]})
    return out


def serve_rowclone_example(dev) -> dict:
    """``python -m repro_torch.examples.serve_rowclone`` (the JAX
    package's serving example, the same arguments) in a subprocess on the
    card: it must exit 0 and print its summary, eight requests served on
    the card."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.serve_rowclone"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"serve_rowclone exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    text = proc.stdout
    summary = json.loads(text[text.index("{"):text.index("\n}\n") + 2])
    if not (summary["device"].startswith("cuda")
            and summary["requests"] == 8 and summary["tokens"] == 64
            and summary["engine_stats"]["prefix_hits"] > 0):
        raise AssertionError(f"serve_rowclone: {json.dumps(summary)}")
    return {"phase": "serve_rowclone", "seconds": seconds,
            "device": summary["device"], "requests": summary["requests"],
            "tokens": summary["tokens"],
            "prefix_hits": summary["engine_stats"]["prefix_hits"],
            "launches_by_kind": summary["launches_by_kind"],
            "pages_in_use_at_end": summary["pages_in_use_at_end"]}


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
    "page_bitwise_batched": ("src/repro_torch/kernels/csrc/ambit.cu",
                             "src/repro/kernels/ambit/ambit.py:48"),
    "page_not_batched": ("src/repro_torch/kernels/csrc/ambit.cu",
                         "src/repro/kernels/ambit/ambit.py:91"),
    "page_zero_scan": ("src/repro_torch/kernels/csrc/ambit.cu",
                       "src/repro/kernels/ambit/ambit.py:135"),
    "state_scatter": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                      "src/repro/kernels/ssm_scan/ssm_scan.py:35"),
    # no Pallas kernel: XLA fuses the JAX package's decode step
    "ssd_step": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                 "none (src/repro/models/ssm.py:158, fused by XLA)"),
    "copy_2d": ("src/repro_torch/kernels/csrc/rowclone.cu",
                "src/repro/kernels/rowclone/rowclone.py:56"),
    "init_2d": ("src/repro_torch/kernels/csrc/rowclone.cu",
                "src/repro/kernels/rowclone/rowclone.py:76"),
    "page_copy": ("src/repro_torch/kernels/csrc/rowclone.cu",
                  "src/repro/kernels/rowclone/rowclone.py:105"),
    "page_init": ("src/repro_torch/kernels/csrc/rowclone.cu",
                  "src/repro/kernels/rowclone/rowclone.py:253"),
}
# the kernels each serving phase must launch
PHASE3_KERNELS = ("kv_scatter", "page_copy_batched", "page_init_batched",
                  "paged_attention", "flash_attention")
CHUNKED_KERNELS = ("kv_scatter", "page_init_batched", "paged_attention",
                   "flash_attention_prefix", "random_u32")
PREFIX_KERNELS = ("kv_scatter", "page_init_batched", "paged_attention",
                  "flash_attention_prefix", "page_zero_scan")
LIB_KERNELS = ("page_bitwise_batched", "page_not_batched")
SSM_KERNELS = ("state_scatter", "ssd_step", "page_copy_batched",
               "page_init_batched")
SSM_CHUNKED_KERNELS = ("state_scatter", "ssd_step", "page_init_batched",
                       "random_u32")
HYBRID_KERNELS = ("kv_scatter", "paged_attention", "flash_attention_prefix",
                  "state_scatter", "ssd_step", "page_init_batched")
MOE_KERNELS = ("kv_scatter", "paged_attention", "flash_attention",
               "page_init_batched")
SWEEP_KERNELS = ("copy_2d", "init_2d", "page_copy", "page_init",
                 "page_copy_batched", "page_init_batched")


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
    torch.set_float32_matmul_precision("highest")
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
    rows.update(rowclone_api_parity(dev))
    emit({"phase": "parity", **rows})
    sweep_line, counts_sweep = rowclone_sweep(dev)
    emit(sweep_line)
    cfg, params, init_s = granite_params(dev)
    counts, greedy, round_ms = serving(dev, cfg, params, init_s)
    counts_chunked = serving_chunked(dev, cfg, params, greedy)
    # phase 8 before phase 6, which scales the weights in place, and
    # every timed serving phase before phase 5's profiler, which leaves
    # host cost behind in the process; granite's weights make room for
    # the SSM and hybrid models and are drawn again (same seed) after
    prefix = serving_prefix(dev, cfg, params)
    emit(prefix)
    emit(trace_replay(dev, cfg, params))
    del params
    _free_card()
    ssm = serving_ssm(dev)
    emit(ssm)
    hybrid = serving_hybrid(dev)
    emit(hybrid)
    emit(ssm_cross_check(dev))
    cfg, params, _ = granite_params(dev)
    graphs = graphs_phase(dev, cfg, params)
    traced = trace(dev, cfg, params)
    emit(traced)
    traced_ssm = trace_ssm(dev)
    emit(traced_ssm)
    graphs["granite"]["profiled_replay"] = traced["decode_captured"]
    graphs["mamba2"]["profiled_replay"] = traced_ssm["decode_captured"]
    emit(graphs)
    emit(chunked_vs_monolithic(dev, cfg, params))
    oracle = eager_oracle(dev, cfg, params)
    emit(oracle)
    del params
    torch.cuda.empty_cache()
    emit(cross_check(dev))
    lib_line, counts_lib = ambit_lib(dev)
    emit(lib_line)
    emit(forward_cross_check(dev))
    llava, counts_llava = serving_llava(dev)
    emit(llava)
    t19 = time.perf_counter()
    emit(train_cross_check(dev))
    emit(train_full(dev))
    emit(train_restart(dev))
    train_s = time.perf_counter() - t19
    # phases 20-21: each rank is a fresh process on the card, so this
    # process first frees what it holds
    _free_card()
    t20 = time.perf_counter()
    tp1, counts_tp1 = tp_world1(dev, greedy, round_ms, card)
    emit(tp1)
    tp2, counts_tp2 = tp_world2(dev, card)
    emit(tp2)
    dp = dp_training(dev, card)
    emit(dp)
    dist_s = time.perf_counter() - t20
    t22 = time.perf_counter()
    zero = zero_training(dev, card, dp)
    emit(zero)
    zero_s = time.perf_counter() - t22
    t24 = time.perf_counter()
    emit(rule_training(dev, card, zero))
    rule_s = time.perf_counter() - t24
    emit(serve_rowclone_example(dev))
    _free_card()
    t23 = time.perf_counter()
    emit(dryrun_phase(dev, card))
    dryrun_s = time.perf_counter() - t23

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = rows[name]
        launches = (counts[name] + counts_chunked[name]
                    + prefix["kernel_launches"][name] + counts_lib[name]
                    + counts_sweep[name]
                    + ssm["kernel_launches"][name]
                    + hybrid["kernel_launches"][name]
                    + oracle["kernel_launches"].get(name, 0)
                    + counts_llava[name] + counts_tp1.get(name, 0)
                    + counts_tp2.get(name, 0))
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    emit({"phase": "total", "seconds": time.perf_counter() - t0,
          "training_seconds": train_s, "distributed_seconds": dist_s,
          "zero_seconds": zero_s, "rule_training_seconds": rule_s,
          "dryrun_seconds": dryrun_s,
          "nvidia_smi": card})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
