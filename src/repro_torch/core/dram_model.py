"""Simulated DRAM device with subarray structure and PiM cell physics.

PiDRAM operates on *real* DDR3 chips whose internal organization
(row->subarray mapping, per-cell reliability under violated timings) is
proprietary and chip-specific.  This module provides the software stand-in
for that device so the framework's system layers (subarray discovery,
allocator, POC, D-RaNGe characterization) operate against the same opaque
interface they would have on hardware:

* rows grouped into subarrays with a *hidden, scrambled* row->subarray map
  (the framework must discover it, exactly like on a real chip);
* RowClone (ACT->PRE->ACT) succeeds **iff** source and destination rows sit
  in the same subarray (charge sharing happens over shared bitlines and
  sense amplifiers; rows in different subarrays do not share them);
* D-RaNGe: under violated tRCD each cell fails with a fixed per-cell
  probability; most cells are deterministic (p ~ 0 or ~ 1), a small
  fraction are metastable (p ~ 0.5) — the "RNG cells" that D-RaNGe
  characterizes and harvests.

The model is deliberately numpy-based (it is a device model, not a
differentiable program).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class DRAMGeometry:
    num_subarrays: int = 64
    rows_per_subarray: int = 512
    row_bytes: int = 8192

    @property
    def num_rows(self) -> int:
        return self.num_subarrays * self.rows_per_subarray

    @property
    def total_bytes(self) -> int:
        return self.num_rows * self.row_bytes


@dataclass(frozen=True)
class CellPhysics:
    """Per-cell activation-failure behaviour under violated tRCD.

    ``rng_cell_fraction`` of cells are metastable with failure probability
    drawn near 0.5; the rest are deterministic.  Matches the qualitative
    characterization in D-RaNGe (Kim et al., HPCA'19): cells are
    overwhelmingly deterministic, with a sparse population of true-random
    cells whose behaviour is stable across time but spatially random.

    Frozen: one ``CellPhysics`` may be shared by many devices, so it must
    not carry mutable per-device state.
    """

    rng_cell_fraction: float = 0.004
    rng_prob_low: float = 0.40
    rng_prob_high: float = 0.60
    deterministic_flip_fraction: float = 0.03  # cells that always fail


class SimulatedDRAM:
    """A simulated DDR3 device exposing PiM-relevant behaviours.

    Only row-granularity data movement is modelled with real data (that is
    what RowClone needs); column reads model D-RaNGe's bit sampling.
    """

    def __init__(
        self,
        geometry: Optional[DRAMGeometry] = None,
        physics: Optional[CellPhysics] = None,
        seed: int = 0xD12A,
    ) -> None:
        # Defaults are constructed per call: a single mutable default
        # instance evaluated at def-time would alias state across every
        # default-constructed device.
        self.geometry = geometry = DRAMGeometry() if geometry is None else geometry
        self.physics = physics = CellPhysics() if physics is None else physics
        self._rng = np.random.default_rng(seed)

        # Hidden row -> subarray map.  Real chips scramble row addresses;
        # we emulate that with a keyed permutation of row indices so that
        # consecutive physical row numbers are NOT guaranteed to share a
        # subarray (the discovery methodology has to cope with this).
        perm = self._rng.permutation(geometry.num_rows)
        self._row_to_subarray = perm % geometry.num_subarrays

        # Backing store, row-major.
        self._data = np.zeros((geometry.num_rows, geometry.row_bytes), np.uint8)

        # Ambit B-group: designated compute rows per subarray, *outside*
        # the addressable row space (the allocator can never hand them
        # out).  Slots 0-2 are the triple-row-activation operands
        # T0/T1/T2; slot 3 is the dual-contact-cell (DCC) row used for
        # in-DRAM NOT.  See Seshadri et al., "Ambit" (MICRO'17).
        self._bgroup = np.zeros(
            (geometry.num_subarrays, 4, geometry.row_bytes), np.uint8
        )

        # D-RaNGe cell physics: per-cell failure probability for the first
        # `drange_region_bytes` of each row (characterizing the whole device
        # would be slow and is unnecessary for the case study).
        self.drange_region_bytes = 128
        n_cells = geometry.num_rows * self.drange_region_bytes * 8
        u = self._rng.random(n_cells, dtype=np.float32)
        probs = np.zeros(n_cells, dtype=np.float32)
        det_flip = u < physics.deterministic_flip_fraction
        probs[det_flip] = 1.0
        is_rng = (u >= physics.deterministic_flip_fraction) & (
            u < physics.deterministic_flip_fraction + physics.rng_cell_fraction
        )
        probs[is_rng] = self._rng.uniform(
            physics.rng_prob_low, physics.rng_prob_high, int(is_rng.sum())
        ).astype(np.float32)
        self._fail_prob = probs.reshape(
            geometry.num_rows, self.drange_region_bytes * 8
        )

    # ------------------------------------------------------------------ #
    # Introspection (test-only; the framework must not peek)
    # ------------------------------------------------------------------ #

    def _true_subarray_of(self, row: int) -> int:
        return int(self._row_to_subarray[row])

    # ------------------------------------------------------------------ #
    # Standard DRAM operation
    # ------------------------------------------------------------------ #

    def read_row(self, row: int) -> np.ndarray:
        return self._data[row].copy()

    def write_row(self, row: int, payload: np.ndarray) -> None:
        assert payload.shape == (self.geometry.row_bytes,)
        self._data[row] = payload

    # ------------------------------------------------------------------ #
    # PiM operations (issued by the memory controller with violated
    # timings; success/behaviour is governed by device physics)
    # ------------------------------------------------------------------ #

    def rowclone(self, src_row: int, dst_row: int) -> bool:
        """ACT(src) -> PRE -> ACT(dst) with violated tRAS/tRP.

        Returns True when the copy actually happened (same subarray).
        When rows are in different subarrays the destination row's charge
        is restored by its own sense amplifiers and the data is unchanged
        — exactly the observable failure mode used by the paper's
        subarray-discovery methodology.
        """
        if self._row_to_subarray[src_row] != self._row_to_subarray[dst_row]:
            return False
        self._data[dst_row] = self._data[src_row]
        return True

    def ambit_bitwise(self, src_row: int, dst_row: int, op: str) -> bool:
        """Ambit bulk AND/OR via triple-row activation (TRA).

        The controller stages both operands and a control row into the
        subarray's B-group (T0/T1/T2), simultaneously activates all three,
        and charge sharing drives the bitlines to the *majority* of the
        three cells: MAJ(a, b, 0) = a & b, MAJ(a, b, 1) = a | b.  The
        result is copied back over ``dst_row`` (two-operand in-place
        semantics: dst <- src OP dst).

        Like RowClone, TRA only works over shared bitlines: returns False
        (destination unchanged) when the rows sit in different subarrays.
        """
        if op not in ("and", "or"):
            raise ValueError(f"unknown ambit bitwise op {op!r}")
        sa = self._row_to_subarray[src_row]
        if sa != self._row_to_subarray[dst_row]:
            return False
        t = self._bgroup[int(sa)]
        t[0] = self._data[src_row]                    # AAP src -> T0
        t[1] = self._data[dst_row]                    # AAP dst -> T1
        t[2] = 0x00 if op == "and" else 0xFF          # AAP C0/C1 -> T2
        maj = (t[0] & t[1]) | (t[0] & t[2]) | (t[1] & t[2])
        t[0] = t[1] = t[2] = maj                      # TRA: all three rows
        self._data[dst_row] = maj                     # AAP T0 -> dst
        return True

    def ambit_not(self, src_row: int, dst_row: int) -> bool:
        """Ambit NOT via the dual-contact-cell (DCC) row: activating the
        source row with the DCC's negated wordline couples the inverted
        value into the DCC cell; copying the DCC row out yields ~src.
        Same-subarray constraint applies (shared bitlines)."""
        sa = self._row_to_subarray[src_row]
        if sa != self._row_to_subarray[dst_row]:
            return False
        t = self._bgroup[int(sa)]
        t[3] = ~self._data[src_row]                   # ACT src couples DCC
        self._data[dst_row] = t[3]                    # AAP DCC -> dst
        return True

    def drange_read(self, row: int, n_bits: int, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Read ``n_bits`` cells of ``row`` with violated tRCD.

        Each sampled bit equals the stored bit XOR a Bernoulli(fail_prob)
        failure.  Rows under test are written with a known pattern by the
        characterization pass, so failures are observable.
        """
        rng = rng or self._rng
        n_bits = min(n_bits, self.drange_region_bytes * 8)
        stored = np.unpackbits(self._data[row, : self.drange_region_bytes])[:n_bits]
        flips = rng.random(n_bits) < self._fail_prob[row, :n_bits]
        return (stored ^ flips.astype(np.uint8)).astype(np.uint8)


@dataclass
class DeviceHandle:
    """What the rest of the framework sees: an opaque device + geometry."""

    device: SimulatedDRAM
    geometry: DRAMGeometry = field(init=False)

    def __post_init__(self) -> None:
        self.geometry = self.device.geometry
