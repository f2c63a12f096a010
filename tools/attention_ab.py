#!/usr/bin/env python3
"""Times the PyTorch/CUDA port's attention kernels of one source tree on
the card, at the shapes of ``chip_smoke.py``'s phase 2.

    python3 tools/attention_ab.py TREE LABEL [--partitions 64,128,256]

TREE is the root of a checkout: its ``src/repro_torch`` is imported and
its two attention kernels are built into ``TREE/build/repro_torch``.
Each run prints one line ``{"tree": LABEL, ...}`` with the mean ms of a
wrapper call (CUDA events over back-to-back calls) of paged attention
(B=8, 32/8 heads, lengths 1-1040, k_self merged), flash attention
(B=4, S=512, causal + lengths) and its prefix-KV mode (a 256-token
chunk over prefixes of 0-1024).  ``--partitions`` also times paged
attention's bare launch at each partition size (the split kernel's
``part`` argument; trees from before the split have none).

To compare two commits on one card, unpack the parent with
``git archive`` into a git-ignored directory and run parent, change,
change, parent in one call; each run is its own process, so the two
trees' packages never meet.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree")
    ap.add_argument("label")
    ap.add_argument("--partitions", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.tree) + "/src")
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops

    _build.build(["flash_attention", "paged_attention"])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    P, S, KVH, D, B, H = 1024, 16, 8, 128, 8, 32
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
    out = {"tree": args.label}
    out["paged_attention"] = time_ms(lambda: pa_ops.paged_attention(
        q, k_ar, v_ar, bt, lens, k_self=k_self, v_self=v_self))
    for part in [int(p) for p in args.partitions.split(",") if p]:
        npart = max(1, -(-width * S // part))
        o = torch.empty_like(q)
        scratch = torch.empty((B, KVH, npart, H // KVH, D + 2),
                              dtype=torch.float32, device=dev)
        tickets = torch.zeros(B * KVH, dtype=torch.int32, device=dev)
        bare = (q.data_ptr(), k_ar.data_ptr(), v_ar.data_ptr(),
                bt.data_ptr(), lens.data_ptr(), k_self.data_ptr(),
                v_self.data_ptr(), o.data_ptr(), None, None,
                scratch.data_ptr(), tickets.data_ptr(), B, H, KVH, D, S,
                width, npart, part, D ** -0.5, 0,
                torch.cuda.current_stream(dev).cuda_stream)
        lib = _build.load("paged_attention")
        out[f"paged_attention_bare_part{part}"] = time_ms(
            lambda: lib.pa_paged_attention(*bare))

    Bf, Sf = 4, 512
    qf, kf, vf = randn(Bf, H, Sf, D), randn(Bf, KVH, Sf, D), \
        randn(Bf, KVH, Sf, D)
    flens = torch.tensor([512, 1, 300, 77], dtype=torch.int32, device=dev)
    out["flash_attention"] = time_ms(lambda: fa_ops.attention(
        qf, kf, vf, causal=True, lengths=flens), iters=10)
    Sc, W = 256, 64
    qc, kc, vc = randn(Bf, H, Sc, D), randn(Bf, KVH, Sc, D), \
        randn(Bf, KVH, Sc, D)
    btp = perm[:Bf * W].view(Bf, W).long().to(dev)
    kp = k_ar[btp].view(Bf, W * S, KVH, D).transpose(1, 2)
    vp = v_ar[btp].view(Bf, W * S, KVH, D).transpose(1, 2)
    pkw = dict(causal=True, k_prefix=kp, v_prefix=vp,
               lengths=torch.tensor([256, 256, 100, 256], dtype=torch.int32,
                                    device=dev),
               prefix_lengths=torch.tensor([0, 16, 600, 1024],
                                           dtype=torch.int32, device=dev))
    out["flash_attention_prefix"] = time_ms(
        lambda: fa_ops.attention(qc, kc, vc, **pkw), iters=10)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
