#!/usr/bin/env python3
"""Times the PyTorch/CUDA port's RowClone wrappers of one source tree on
the card, at the shapes of ``chip_smoke.py``'s phases 2 and 13.

    python3 tools/rowclone_ab.py TREE LABEL

TREE is the root of a checkout: its ``src/repro_torch`` is imported and
its RowClone kernels are built into ``TREE/build/repro_torch``.  Each
run prints the card's name and power limit, then one line
``{"tree": LABEL, ...}`` with the mean ms of a call (CUDA events over
back-to-back calls) of:

* ``kv_scatter``: one arena (L=40, P=1024, 16 slots of 8 x 128 bf16,
  B=8 with two pad duplicates), and the (K, V) pair a decode round
  writes: two single calls, and the pair form where the tree has one;
* ``page_init_batched``: 16 pages over 40 layers of one arena, and the
  pair the queue's flush inits: two calls, or the pair form;
* ``page_init``: 16 pages of one (1024, 16384) bf16 layer;
* ``page_copy_batched``: 16 pages over 40 layers of one arena, an
  overlapping batch (op 15 writes the page op 0 reads) and a disjoint
  one, and the (K, V) pair a CoW flush copies: two calls, or the pair
  form where the tree has one; mamba2-1.3b's state fork, 1 and 8 rows
  of its conv (48 layers, 3 x 4352 bf16) and SSD (64 x 64 x 128 f32,
  2 MiB) arenas: two ``pim_state_copy`` calls, or the pair form;
* ``page_copy``: 16 pages of one (1024, 16384) bf16 layer, disjoint and
  overlapping (a duplicate destination too), with ``index_select`` +
  ``index_copy_`` (``two_calls``) beside it, and phase 13's 40 looped
  calls (one a layer of the KV arena);
* ``copy_routes`` (trees with ``rc_copy_pages``): the bare kernel on a
  disjoint batch down its direct route (16-byte loads and stores in
  registers) and down the cluster route (TMA bulk copies through shared
  memory), for the 16 KV pages and one 2 MiB state row;
* ``copy_2d`` (``pim_copy``) and ``init_2d`` (``pim_init(..., 0)``) of
  1 MiB, 32 MiB, 256 MiB and the whole (40, 1024, 16, 8, 128) bf16
  arena (1.34 GB), each beside ``Tensor.clone()`` and ``torch.zeros``;
* ``reread_us``: the median µs of one read (``sum``) of a 16 MiB working
  set enqueued right after a 256 MiB ``copy_2d``, ``clone``, ``init_2d``
  or ``zeros`` (``warm``: after a read of the set alone), 30 samples of
  CUDA events around the read: how much of the set the mover left in L2;
* the library calls of the same functions (``index_copy_`` and
  ``index_fill_`` on indices already on the card).

To compare two commits on one card, unpack the parent with
``git archive`` into a git-ignored directory and run parent, change,
change, parent in one call; each run is its own process, so the two
trees' packages never meet.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

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


def reread_us(ws: torch.Tensor, move, samples: int = 30) -> float:
    """Median µs of reading ``ws`` right after ``move()`` (after a read
    of ``ws`` alone when ``move`` is None)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(samples + 2):
        ws.sum()
        if move is not None:
            move()
        start.record()
        ws.sum()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    return sorted(times[2:])[samples // 2]


def copy_routes(rc_ops, k_ar, ssm, disjoint, dev) -> dict:
    """The bare ``rc_copy_pages`` launch of a disjoint batch down each of
    its two one-launch routes (0: direct, 1: cluster)."""
    from array import array

    from repro_torch.kernels import _build

    lib = _build.load("rowclone")
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = {}
    for what, arena, (src, dst) in (("kv_16_pages", k_ar, disjoint),
                                    ("state_1_row", ssm, ([0], [15]))):
        L, P = arena.shape[:2]
        desc = array("q", [arena.data_ptr(), arena.data_ptr(), P, P,
                           rc_ops._row_bytes(arena, 2), L]).tobytes()
        pairs = array("i", src + dst).tobytes()
        for route in (0, 1):
            args = (desc, 1, None, pairs, len(src), 0, route, stream)
            if lib.rc_copy_pages(*args) != 0:
                raise RuntimeError(f"rc_copy_pages route {route} refused")
            out[f"{what}_route{route}"] = time_ms(
                lambda: lib.rc_copy_pages(*args))
    return out


def page_copies(rc_ops, k_ar, v_ar, layer, dev) -> dict:
    """The page copy's wrappers at ``chip_smoke.py`` phase 2's shapes."""
    from repro_torch.kernels.ssm_scan import ops as ss_ops

    out = {}
    over = (list(range(100, 116)), list(range(200, 215)) + [100])
    disjoint = (list(range(300, 316)), list(range(400, 416)))
    for what, (src, dst) in (("overlapping", over), ("disjoint", disjoint)):
        s_t = torch.tensor(src, device=dev)
        d_t = torch.tensor(dst, device=dev)
        out[f"page_copy_batched_{what}"] = time_ms(
            lambda: rc_ops.pim_page_copy_batched(k_ar, src, dst))
        out[f"page_copy_batched_{what}_two_calls"] = time_ms(lambda: (
            rc_ops.pim_page_copy_batched(k_ar, src, dst),
            rc_ops.pim_page_copy_batched(v_ar, src, dst)))
        if hasattr(rc_ops, "pim_page_copy_batched_pair"):
            out[f"page_copy_batched_{what}_pair"] = time_ms(
                lambda: rc_ops.pim_page_copy_batched_pair(k_ar, v_ar, src,
                                                          dst))
        out[f"index_select_copy_{what}"] = time_ms(
            lambda: k_ar.index_copy_(1, d_t, k_ar.index_select(1, s_t)))
        out[f"page_copy_{what}"] = time_ms(
            lambda: rc_ops.pim_page_copy(layer, src, dst))
        out[f"page_copy_{what}_two_calls"] = time_ms(
            lambda: layer.index_copy_(0, d_t, layer.index_select(0, s_t)))
    out["page_copy_duplicate"] = time_ms(lambda: rc_ops.pim_page_copy(
        layer, over[0], list(range(200, 214)) + [213, 100]))

    def looped():
        for l in range(k_ar.shape[0]):
            rc_ops.pim_page_copy(k_ar[l], list(range(100, 116)),
                                 list(range(200, 216)))
    out["page_copy_looped_40"] = time_ms(looped, 20)
    gen = torch.Generator(device=dev).manual_seed(1)
    L, R = 48, 16
    conv = torch.randn((L, 1, R, 3, 4352), generator=gen, device=dev,
                       dtype=torch.bfloat16)
    ssm = torch.randn((L, 1, R, 64, 64, 128), generator=gen, device=dev)
    if hasattr(rc_ops, "copy_route"):
        out["copy_routes"] = copy_routes(rc_ops, k_ar, ssm.view(L, R, -1),
                                         disjoint, dev)
    for n in (1, 8):
        src, dst = list(range(n)), list(range(R - n, R))
        out[f"state_copy_{n}_rows"] = time_ms(
            lambda: ss_ops.pim_state_copy(ssm, src, dst))
        out[f"state_fork_{n}_rows_two_calls"] = time_ms(lambda: (
            ss_ops.pim_state_copy(conv, src, dst),
            ss_ops.pim_state_copy(ssm, src, dst)))
        if hasattr(ss_ops, "pim_state_copy_pair"):
            out[f"state_fork_{n}_rows_pair"] = time_ms(
                lambda: ss_ops.pim_state_copy_pair(conv, ssm, src, dst))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree")
    ap.add_argument("label")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rowclone_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.tree) + "/src")
    from repro_torch.kernels import _build
    from repro_torch.kernels.rowclone import ops as rc_ops

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip(), flush=True)
    _build.build(["rowclone"])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    L, P, S, KVH, D, B = 40, 1024, 16, 8, 128, 8
    E = KVH * D
    k_ar, v_ar = randn(L, P, S, KVH, D), randn(L, P, S, KVH, D)
    k_new, v_new = randn(L, B, KVH, D), randn(L, B, KVH, D)
    for new in (k_new, v_new):
        new[:, 6] = new[:, 0]
        new[:, 7] = new[:, 1]
    pages = torch.tensor([3, 17, 200, 511, 800, 1000, 3, 17],
                         dtype=torch.int32, device=dev)
    slots = torch.tensor([0, 5, 15, 7, 1, 9, 0, 5], dtype=torch.int32,
                         device=dev)
    flat_k, flat_v = k_ar.view(L, P * S, E), v_ar.view(L, P * S, E)
    flat_idx = pages.long() * S + slots.long()
    out = {"tree": args.label}
    out["kv_scatter"] = time_ms(
        lambda: rc_ops.kv_scatter_inline(k_ar, pages, slots, k_new))
    out["kv_scatter_two_calls"] = time_ms(lambda: (
        rc_ops.kv_scatter_inline(k_ar, pages, slots, k_new),
        rc_ops.kv_scatter_inline(v_ar, pages, slots, v_new)))
    if hasattr(rc_ops, "kv_scatter_pair_inline"):
        out["kv_scatter_pair"] = time_ms(
            lambda: rc_ops.kv_scatter_pair_inline(k_ar, v_ar, pages, slots,
                                                  k_new, v_new))
    out["index_copy"] = time_ms(
        lambda: flat_k.index_copy_(1, flat_idx, k_new.view(L, B, E)))
    out["index_copy_two_calls"] = time_ms(lambda: (
        flat_k.index_copy_(1, flat_idx, k_new.view(L, B, E)),
        flat_v.index_copy_(1, flat_idx, v_new.view(L, B, E))))

    init_pages = list(range(200, 215)) + [100]
    init_idx = torch.tensor(init_pages, device=dev)
    out["page_init_batched"] = time_ms(
        lambda: rc_ops.pim_page_init_batched(k_ar, init_pages, 0.0))
    out["page_init_batched_two_calls"] = time_ms(lambda: (
        rc_ops.pim_page_init_batched(k_ar, init_pages, 0.0),
        rc_ops.pim_page_init_batched(v_ar, init_pages, 0.0)))
    if hasattr(rc_ops, "pim_page_init_batched_pair"):
        out["page_init_batched_pair"] = time_ms(
            lambda: rc_ops.pim_page_init_batched_pair(k_ar, v_ar, init_pages,
                                                      0.0))
    out["index_fill"] = time_ms(lambda: k_ar.index_fill_(1, init_idx, 0.0))
    out["index_fill_two_calls"] = time_ms(lambda: (
        k_ar.index_fill_(1, init_idx, 0.0),
        v_ar.index_fill_(1, init_idx, 0.0)))

    layer = k_ar[0].reshape(P, -1).clone()
    dst = list(range(400, 416))
    dst_idx = torch.tensor(dst, device=dev)
    out["page_init"] = time_ms(lambda: rc_ops.pim_page_init(layer, dst, 0.0))
    out["index_fill_layer"] = time_ms(
        lambda: layer.index_fill_(0, dst_idx, 0.0))
    out.update(page_copies(rc_ops, k_ar, v_ar, layer, dev))
    del layer, v_ar
    flat = k_ar.view(-1)
    for nbytes in (1 << 20, 32 << 20, 256 << 20, flat.numel() * 2):
        src = flat[:nbytes // 2]
        iters = 50 if nbytes <= (32 << 20) else 20
        out[f"copy_2d_{nbytes}"] = time_ms(lambda: rc_ops.pim_copy(src),
                                           iters)
        out[f"clone_{nbytes}"] = time_ms(src.clone, iters)
        out[f"init_2d_{nbytes}"] = time_ms(lambda: rc_ops.pim_init(
            src.shape, 0, torch.bfloat16, device=dev), iters)
        out[f"zeros_{nbytes}"] = time_ms(lambda: torch.zeros(
            src.shape, dtype=torch.bfloat16, device=dev), iters)
    ws = torch.ones(4 << 20, dtype=torch.float32, device=dev)
    src = flat[:(256 << 20) // 2]
    out["reread_us"] = {
        "warm": reread_us(ws, None),
        "copy_2d": reread_us(ws, lambda: rc_ops.pim_copy(src)),
        "clone": reread_us(ws, src.clone),
        "init_2d": reread_us(ws, lambda: rc_ops.pim_init(
            src.shape, 0, torch.bfloat16, device=dev)),
        "zeros": reread_us(ws, lambda: torch.zeros(
            src.shape, dtype=torch.bfloat16, device=dev))}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
