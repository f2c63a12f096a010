"""Trial-based DRAM subarray discovery (PiDRAM SS4.2 methodology).

RowClone requires source and destination rows to live in the *same DRAM
subarray*, but the row->subarray map is proprietary and chip-specific.
PiDRAM's supervisor software discovers it empirically: write known
patterns, attempt RowClone between candidate row pairs, and check whether
the destination changed.  Rows are then clustered into subarray groups
that the allocator consumes.

This module implements that methodology against the opaque
:class:`MemoryController` / :class:`SimulatedDRAM` interface — it never
reads the device's hidden map.

Discovery cost is O(rows) RowClone trials, not O(rows^2): each unmatched
row is trial-copied against one *representative* row per known group, and
a union-find collapses groups discovered to be equal (transitivity of
same-subarray membership lets us stop at the first hit).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .memctrl import MemoryController


@dataclass
class SubarrayMap:
    """Discovered row -> subarray-group mapping."""

    group_of: Dict[int, int] = field(default_factory=dict)
    members: Dict[int, List[int]] = field(default_factory=dict)
    trials: int = 0

    def same_subarray(self, a: int, b: int) -> bool:
        return (
            a in self.group_of
            and b in self.group_of
            and self.group_of[a] == self.group_of[b]
        )

    @property
    def num_groups(self) -> int:
        return len(self.members)


def _trial_rowclone(mc: MemoryController, src: int, dst: int, seed: int) -> bool:
    """One trial: write distinct patterns, attempt copy, verify."""
    rb = mc.device.geometry.row_bytes
    rng = np.random.default_rng(seed)
    pattern = rng.integers(0, 256, rb, dtype=np.uint8)
    anti = ~pattern
    mc.device.write_row(src, pattern)
    mc.device.write_row(dst, anti)
    mc.run_sequence("rowclone_copy", src, dst)
    return bool((mc.device.read_row(dst) == pattern).all())


def discover_subarrays(
    mc: MemoryController,
    rows: Optional[List[int]] = None,
    max_rows: Optional[int] = None,
    seed: int = 7,
) -> SubarrayMap:
    """Cluster ``rows`` into same-subarray groups via RowClone trials.

    Destructive to row contents (characterization pass runs before the
    allocator hands out rows, exactly as on the prototype).
    """
    geo = mc.device.geometry
    if rows is None:
        rows = list(range(geo.num_rows if max_rows is None else max_rows))

    smap = SubarrayMap()
    representatives: List[int] = []  # one row per discovered group

    for row in rows:
        placed = False
        for gid, rep in enumerate(representatives):
            smap.trials += 1
            if _trial_rowclone(mc, rep, row, seed + smap.trials):
                smap.group_of[row] = gid
                smap.members[gid].append(row)
                placed = True
                break
        if not placed:
            gid = len(representatives)
            representatives.append(row)
            smap.group_of[row] = gid
            smap.members[gid] = [row]
    return smap
