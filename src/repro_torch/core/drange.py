"""D-RaNGe: DRAM-latency true random number generation, end to end.

Implements the paper's second case study as a full pipeline over the
simulated device + POC:

  1. **Characterization**: write known patterns, sample every candidate
     cell many times under violated tRCD, estimate per-cell failure
     probability, select *RNG cells* (p in [lo, hi] around 0.5).
  2. **Generation**: repeatedly issue DR_GEN instructions on rows that
     contain >= 4 RNG cells, harvest the selected cells' bits, and push
     them through the POC's random-number buffer.
  3. **Consumption**: `rand_dram()` — the pimolib call — drains the buffer
     via the data register, exactly as in the paper's workflow.

Throughput/latency figures come from the memory-controller timing model
(validated against the paper's 220 ns / 8.30 Mb/s in benchmarks).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from .isa import Instruction, Opcode
from .memctrl import MemoryController
from .poc import PimOpsController


@dataclass
class RngCellMap:
    """Characterization output: per-row indices of RNG cells."""

    cells: Dict[int, List[int]] = field(default_factory=dict)
    samples_per_cell: int = 0

    def rows_with(self, min_cells: int) -> List[int]:
        return [r for r, cs in self.cells.items() if len(cs) >= min_cells]

    @property
    def total_cells(self) -> int:
        return sum(len(c) for c in self.cells.values())


def characterize(
    mc: MemoryController,
    rows: List[int],
    n_bits: int = 64,
    samples: int = 200,
    p_lo: float = 0.35,
    p_hi: float = 0.65,
    seed: int = 11,
) -> RngCellMap:
    """Estimate per-cell failure probability; select metastable cells.

    Cells are written with zeros so any 1 read back is an activation
    failure.  (A second pass with ones would reject stuck-at cells; the
    simulated physics has no asymmetric stuck-ats, and on hardware the
    paper uses both patterns — noted in DESIGN.md.)
    """
    geo = mc.device.geometry
    zero = np.zeros(geo.row_bytes, np.uint8)
    cmap = RngCellMap(samples_per_cell=samples)
    for row in rows:
        mc.device.write_row(row, zero)
        counts = np.zeros(n_bits, np.int64)
        for _ in range(samples):
            res = mc.run_sequence("drange_read", row, n_bits)
            counts += res.data.astype(np.int64)
        p = counts / samples
        sel = np.nonzero((p >= p_lo) & (p <= p_hi))[0]
        if sel.size:
            cmap.cells[row] = sel.tolist()
    return cmap


class DRangeTRNG:
    """End-to-end TRNG using the POC protocol (pimolib `rand_dram`)."""

    def __init__(
        self,
        poc: PimOpsController,
        cmap: RngCellMap,
        bits_per_read: int = 4,
    ) -> None:
        self.poc = poc
        self.cmap = cmap
        self.bits_per_read = bits_per_read
        self.rows = cmap.rows_with(bits_per_read)
        if not self.rows:
            raise ValueError("characterization found no usable RNG rows")
        self._row_idx = 0
        self.stats = {"reads": 0, "bits": 0}

    def _refill(self, want_bits: int) -> None:
        zero_written: set = set()
        while self.poc.rng_bits_available() < want_bits:
            row = self.rows[self._row_idx % len(self.rows)]
            self._row_idx += 1
            if row not in zero_written:
                # RNG rows hold zeros; failures are the entropy.
                self.poc.mc.device.write_row(
                    row, np.zeros(self.poc.mc.device.geometry.row_bytes, np.uint8)
                )
                zero_written.add(row)
            n_bits = max(self.cmap.cells[row][-1] + 1, 1)
            held = list(self.poc.rng_buffer)          # previously harvested bits
            self.poc.rng_buffer.clear()
            insn = Instruction(Opcode.DR_GEN, operand0=row, operand1=n_bits)
            self.poc.store_instruction(insn.encode())
            self.poc.store_start()
            # Keep only characterized RNG cells (the scheduler's cell mask).
            raw = list(self.poc.rng_buffer)
            self.poc.rng_buffer.clear()
            kept = [raw[i] for i in self.cmap.cells[row] if i < len(raw)]
            self.poc.rng_buffer.extend(held + kept)
            self.stats["reads"] += 1

    def random_bits(self, n: int) -> np.ndarray:
        """Return ``n`` true-random bits via the POC buffer protocol."""
        out: List[int] = []
        while len(out) < n:
            self._refill(min(64, n - len(out)))
            take = min(64, self.poc.rng_bits_available(), n - len(out))
            insn = Instruction(Opcode.READ_BUF, operand0=take)
            self.poc.store_instruction(insn.encode())
            self.poc.store_start()
            word = self.poc.load_data()
            out.extend((word >> i) & 1 for i in range(take))
        self.stats["bits"] += n
        return np.array(out[:n], np.uint8)

    def random_u32(self, n: int) -> np.ndarray:
        bits = self.random_bits(32 * n).reshape(n, 32)
        return (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(axis=1).astype(np.uint32)


# -------------------- statistical quality checks ------------------------ #


def monobit_fraction(bits: np.ndarray) -> float:
    """Fraction of ones; ideal 0.5."""
    return float(bits.mean())


def runs_count(bits: np.ndarray) -> int:
    """Number of runs; for n fair bits expected ~ n/2 + 1."""
    return int(1 + np.count_nonzero(np.diff(bits)))


def serial_correlation(bits: np.ndarray) -> float:
    x = bits.astype(np.float64) - bits.mean()
    denom = float((x * x).sum())
    if denom == 0.0:
        return 1.0
    return float((x[:-1] * x[1:]).sum() / denom)
