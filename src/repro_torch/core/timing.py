"""DDR3 timing parameters and violated-timing command sequences.

This module is the timing vocabulary of the PiDRAM memory-controller model
(`repro_torch.core.memctrl`).  All parameters default to the values of the PiDRAM
FPGA prototype (Xilinx ZC706, Rocket @ 50 MHz, DDR3-800 SO-DIMM, 64-bit bus,
8 KB rows) as described in the paper and its extended arXiv version.

Two kinds of sequences are expressed here:

* **Standard sequences** honour manufacturer-recommended timings
  (tRCD, tRAS, tRP, tCL, ...).
* **Violated sequences** shrink selected parameters far below spec — the
  physical mechanism of commodity-DRAM PiM (RowClone via ComputeDRAM
  ACT->PRE->ACT, D-RaNGe via tRCD violation).

All times are expressed in nanoseconds; the memory controller model converts
to CPU cycles where needed.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class DDR3Timings:
    """Manufacturer-recommended DDR3-800 timing parameters (ns)."""

    tCK: float = 2.5        # DRAM bus clock period (400 MHz IO clock)
    tRCD: float = 13.75     # ACT -> column command
    tRAS: float = 35.0      # ACT -> PRE (row restore)
    tRP: float = 13.75      # PRE -> next ACT
    tCL: float = 13.75      # read CAS latency
    tCWL: float = 10.0      # write CAS latency
    tBL: float = 10.0       # burst of 8 on 64-bit bus = 64 bytes
    tCCD: float = 10.0      # column-to-column
    tWR: float = 15.0       # write recovery
    tRFC: float = 160.0     # refresh cycle
    tREFI: float = 7800.0   # refresh interval

    @property
    def tRC(self) -> float:
        """Row cycle: back-to-back ACTs to the same bank."""
        return self.tRAS + self.tRP

    def scaled(self, **overrides: float) -> "DDR3Timings":
        return dataclasses.replace(self, **overrides)


@dataclass(frozen=True)
class ViolatedTimings:
    """Reduced timing parameters used by PiM command sequences.

    ComputeDRAM-style RowClone issues ACT -> PRE -> ACT where the gaps
    t1 (ACT->PRE) and t2 (PRE->ACT) are just 1-2 bus cycles, far below
    tRAS/tRP.  D-RaNGe issues a column read only ~1 cycle after ACT,
    far below tRCD, sampling cells mid-sense-amplification.
    """

    t1_act_pre: float = 2.5    # RowClone: ACT->PRE gap (violates tRAS)
    t2_pre_act: float = 2.5    # RowClone: PRE->ACT gap (violates tRP)
    tRCD_viol: float = 2.5     # D-RaNGe: ACT->RD gap (violates tRCD)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class PrototypeParams:
    """Calibrated cost parameters of the PiDRAM FPGA prototype.

    The CPU-side parameters are calibrated once against the paper's
    reported end-to-end numbers (118.5x / 88.7x / 14.6x / 12.6x for
    RowClone and 220 ns / 8.30 Mb/s for D-RaNGe) and then *frozen*; the
    benchmark suite computes every paper number forward from this single
    parameter set.  Calibration rationale (see DESIGN.md SS5):

    * Rocket is a 50 MHz in-order core: byte-moving loops cost ~2-3
      cycles per 8-byte word, DRAM miss stalls are only a few CPU cycles
      because the CPU clock is 8x slower than the DRAM bus clock.
    * MMIO accesses to the POC's uncached registers cross the TileLink
      fabric: ~7 CPU cycles each.
    * CLFLUSH-style writebacks are pipelined by the memory controller and
      bounded by DRAM write bandwidth, ~35 ns per 64-byte block.
    """

    cpu_freq_hz: float = 50e6            # Rocket chip on ZC706
    row_bytes: int = 8192                # one DRAM row (= one page operand)
    cacheline_bytes: int = 64
    word_bytes: int = 8                  # RV64 load/store width

    # memcpy: ld + sd + amortized loop control, per 8-byte word (cycles)
    memcpy_cycles_per_word: float = 2.5
    # memset/calloc zeroing loop, per 8-byte word (cycles)
    memset_cycles_per_word: float = 2.148
    # bitwise read-modify-write loop (2 ld + op + sd), per word (cycles)
    bitwise_cycles_per_word: float = 3.6
    # zero-compare scan loop (ld + cmp + branch), per word (cycles)
    scan_cycles_per_word: float = 2.25
    # additional CPU stall per cache miss (cycles @ 50 MHz)
    miss_stall_cycles: float = 4.5
    # MMIO register access to POC (cycles)
    mmio_store_cycles: float = 6.5
    mmio_load_cycles: float = 6.5
    # pimolib call + supervisor syscall overhead (cycles)
    syscall_cycles: float = 2.6
    # coherence ops, per 64-byte cache block (ns)
    clflush_ns_per_block: float = 34.84  # dirty writeback (copy source)
    clinval_ns_per_block: float = 29.53  # invalidate (init destination)

    # D-RaNGe pipeline
    drange_bits_per_read: int = 4        # RNG cells harvested per access
    drange_latency_ns: float = 220.0     # first 4 bits (ACT_viol+RD+MMIO)
    drange_sustained_ns: float = 482.0   # steady-state per 4-bit chunk

    @property
    def cycle_ns(self) -> float:
        return 1e9 / self.cpu_freq_hz

    @property
    def lines_per_row(self) -> int:
        return self.row_bytes // self.cacheline_bytes

    @property
    def words_per_row(self) -> int:
        return self.row_bytes // self.word_bytes


DEFAULT_TIMINGS = DDR3Timings()
DEFAULT_VIOLATIONS = ViolatedTimings()
DEFAULT_PROTOTYPE = PrototypeParams()
