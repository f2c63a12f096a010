"""D-RaNGe as a system entropy source: characterize the (simulated) DRAM,
build the TRNG, and seed the card's block generator (the ``random_u32``
kernel that sampling draws on) from its true-random bits.

The characterization and the TRNG run on the simulated DDR3 prototype
(numpy); the block is drawn on the card unless ``--device cpu`` is given
(then the generator's plain version runs).

Run:  PYTHONPATH=src python -m repro_torch.examples.drange_entropy [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.core import (DRAMGeometry, DRangeTRNG, MemoryController,
                              PimOpsController, SimulatedDRAM, characterize)
from repro_torch.core.drange import (monobit_fraction, runs_count,
                                     serial_correlation)
from repro_torch.device import resolve_device
from repro_torch.kernels.drange import ops as dr_ops


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the block generator "
                         "(default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    dev = SimulatedDRAM(DRAMGeometry(num_subarrays=8, rows_per_subarray=32))
    mc = MemoryController(dev)
    poc = PimOpsController(mc)

    print("characterizing cells under violated tRCD ...")
    cmap = characterize(mc, rows=list(range(32)), n_bits=1024, samples=100)
    print(f"  RNG cells found: {cmap.total_cells} across "
          f"{len(cmap.cells)} rows; rows with >=4 cells: "
          f"{len(cmap.rows_with(4))}")

    trng = DRangeTRNG(poc, cmap)
    bits = trng.random_bits(4096)
    print("statistical checks on 4096 true-random bits:")
    print(f"  monobit fraction : {monobit_fraction(bits):.4f}  (ideal 0.5)")
    print(f"  serial correlation: {serial_correlation(bits):+.4f} (ideal 0)")
    print(f"  runs             : {runs_count(bits)}  (ideal ~{len(bits)//2})")

    # seed the block generator from the DRAM entropy pool
    seed = dr_ops.entropy_seed_from_trng(trng)
    block = dr_ops.pim_random_uniform(seed, 4, 8, device)
    print(f"\nblock generator on {device} seeded from DRAM entropy:")
    print(block.cpu().numpy())
    return {"bits": bits, "seed": seed, "block": block.cpu()}


if __name__ == "__main__":
    main()
