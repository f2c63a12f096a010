"""Quickstart: the PiDRAM workflow end to end, on the port.

1. Simulate the prototype (DDR3 device + memory controller).
2. Discover subarrays empirically (the paper's section 4.2 method).
3. Allocate RowClone-compatible operands and copy/init in-memory.
4. Generate true random numbers with D-RaNGe.
5. Run the *same* pimolib protocol on the torch face (a ``TorchLib``
   over an arena on the card, the RowClone and D-RaNGe kernels): one
   ``PimLib`` API, two substrates, unified ``OpReceipt`` accounting.
6. Record a serving-style trace of a 2-layer paged KV cache on the
   torch face and replay it on the model face for paper-style
   RowClone-vs-CPU latency totals.

Every latency printed in steps 1-4 and 6 is the simulated DDR3
prototype's (the model face), not a time of the card.  Step 5 runs on
the card unless ``--device cpu`` is given (then the kernels' plain
versions run).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (Blocking, DRAMGeometry, DRangeTRNG, DeviceLib,
                              EndToEndCosts, MemoryController, Opcode,
                              PimOpsController, SimulatedDRAM, TorchLib,
                              allocator_from_subarray_map, characterize,
                              discover_subarrays, make_torch_arena)
from repro_torch.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of step 5 and 6 (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # -- 1. prototype ---------------------------------------------------
    dev = SimulatedDRAM(DRAMGeometry(num_subarrays=8, rows_per_subarray=32))
    mc = MemoryController(dev)
    print("== PiDRAM prototype (simulated DDR3, Rocket @ 50 MHz) ==")
    sp = EndToEndCosts(mc).speedups()
    print("RowClone speedups vs memcpy/calloc (simulated prototype):",
          {k: round(v, 1) for k, v in sp.items()})

    # -- 2. subarray discovery ------------------------------------------
    smap = discover_subarrays(mc, max_rows=64)
    print(f"discovered {smap.num_groups} subarray groups "
          f"in {smap.trials} RowClone trials")

    # -- 3. in-DRAM copy & init (model face of the PimLib protocol) ------
    alloc = allocator_from_subarray_map(smap)
    lib = DeviceLib(PimOpsController(mc), alloc)
    src, dst = alloc.alloc_copy_pair(1, tag="demo")
    payload = np.random.default_rng(0).integers(
        0, 256, (1, dev.geometry.row_bytes), dtype=np.uint8)
    lib.write(src, payload)
    rec = lib.copy(src, dst, blocking=Blocking.FIN)
    if not (lib.read(dst) == payload).all():
        raise RuntimeError("RowClone-Copy did not copy the row")
    print(f"RowClone-Copy: ok={rec.ok}  latency={rec.latency_ns:.0f} ns "
          f"(memcpy would be {lib.cpu_copy(src, dst).latency_ns:.0f} ns)")
    rec = lib.init(dst)
    print(f"RowClone-Init: ok={rec.ok}  latency={rec.latency_ns:.0f} ns")

    # -- 4. D-RaNGe -------------------------------------------------------
    cmap = characterize(mc, rows=list(range(32)), n_bits=1024, samples=60)
    lib.attach_trng(DRangeTRNG(lib.poc, cmap))
    print("supports(DR_GEN) after characterization:",
          lib.supports(Opcode.DR_GEN))
    bits, rec = lib.rand(64)
    print(f"D-RaNGe: 64 true-random bits in {rec.latency_ns:.0f} ns "
          f"(ones fraction {bits.mean():.2f})")

    # -- 5. torch face: the SAME protocol over an arena on the card -------
    print(f"\n== torch face (arena on {device}, RowClone kernels) ==")
    arena = make_torch_arena(num_slabs=2, pages_per_slab=8, page_elems=128,
                             dtype=torch.float32, device=device)
    tlib = TorchLib(arena)
    s, d = arena.allocator.alloc_copy_pair(2)
    tlib.write(s, torch.arange(2 * 128, dtype=torch.float32).reshape(2, 128))
    rec = tlib.copy(s, d, blocking=Blocking.FIN)
    same = bool((tlib.read(d) == tlib.read(s)).all())
    print(f"pim_page_copy: ok={rec.ok}  op={rec.op}  "
          f"launches={rec.launches} (coalesced)")
    print("contents match:", same)
    tbits, rec = tlib.rand(64, seed=(1, 2))
    print(f"pim_rand (D-RaNGe kernel): ones fraction {tbits.mean():.2f}, "
          f"launches={rec.launches}")
    print("stats:", tlib.stats, "| queue:", tlib.queue.stats)

    # -- 6. serving trace, replayed on the model face ---------------------
    print("\n== serving trace -> model-face replay (RowClone vs CPU) ==")
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.serving.kv_cache import PagedKVCache
    from repro_torch.serving.trace import replay_on_device
    cfg = reduced(ARCHS["granite-3-8b"], num_layers=2)
    cache = PagedKVCache(cfg, num_pages=16, page_size=4, num_slabs=2,
                         device=device, record_trace=True)
    seq = cache.create(0, 10)
    k = torch.ones((cache.n_layers, 10, cfg.num_kv_heads,
                    cfg.resolved_head_dim), device=device)
    cache.write_prompt_kv(seq, k, k)     # bulk prompt KV (one launch/arena)
    cache.fork(0, 1)                     # CoW fork: RowClone page copy
    cache.free(0)
    cache.free(1)                        # init-on-free: RowClone init
    rep = replay_on_device(cache.trace)
    print("trace ops:", rep["counts"])
    print(f"pim total:  {rep['pim_ns']['total']:.0f} ns  "
          f"(rowclone_copy {rep['pim_ns']['rowclone_copy']:.0f}, "
          f"rowclone_init {rep['pim_ns']['rowclone_init']:.0f})")
    print(f"cpu total:  {rep['cpu_ns']['total']:.0f} ns")
    print("end-to-end speedup (simulated prototype): "
          f"{rep['speedup']['end_to_end']:.2f}x "
          f"(init {rep['speedup']['init']:.1f}x)")
    return {"speedups": sp, "groups": smap.num_groups, "trials": smap.trials,
            "torch_copy_matches": same, "replay": rep}


if __name__ == "__main__":
    main()
