"""Supervisor-software memory management: subarray-aware allocation.

A copy of the JAX package's ``core/allocator.py`` (pure Python; the
port keeps its own copy and imports nothing of that package).

PiDRAM's custom supervisor software provides the OS primitives that make
RowClone usable: allocation at row granularity, aligned to DRAM rows, with
source/destination placed in the *same subarray*.  This module implements
that allocator over any "address space" organized as groups of rows:

* the simulated DDR3 device (groups = discovered subarrays), used by the
  faithful reproduction, and
* the device arena (groups = arena *slabs*, the contiguity domains inside
  which aliased zero-copy `pim_copy` is legal), used by the serving KV-cache
  manager and the training-state initializer.

The allocator also tracks per-row **coherence state** (clean / dirty-in-
cache), which the end-to-end model uses to decide whether a RowClone needs
CLFLUSH-style maintenance first (paper's 118.5x vs 14.6x distinction).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


class CoherenceState(enum.Enum):
    INVALID = "invalid"      # not cached anywhere; DRAM copy is authoritative
    CLEAN = "clean"          # cached, matches DRAM
    DIRTY = "dirty"          # cached and modified; DRAM copy is stale


class PimAllocError(Exception):
    pass


@dataclass
class Allocation:
    """A row-granularity allocation handle."""

    rows: Tuple[int, ...]
    group: int
    tag: str = ""

    @property
    def nrows(self) -> int:
        return len(self.rows)


@dataclass
class _Group:
    gid: int
    free: List[int]
    total: int


class SubarrayAllocator:
    """Row-granularity allocator with same-subarray placement constraints.

    ``groups`` maps group-id -> list of row ids (from subarray discovery or
    from arena slab layout).  The allocator is deliberately simple —
    per-group free lists with first-fit — because that is what the paper's
    supervisor implements; the interesting property is the *constraint
    language* (``same_group_as=``), not the fitting policy.
    """

    def __init__(self, groups: Dict[int, Sequence[int]]) -> None:
        if not groups:
            raise PimAllocError("no row groups supplied")
        self._groups: Dict[int, _Group] = {
            gid: _Group(gid, list(rows), len(rows)) for gid, rows in groups.items()
        }
        self._owner: Dict[int, Allocation] = {}
        self.coherence: Dict[int, CoherenceState] = {
            r: CoherenceState.INVALID for rows in groups.values() for r in rows
        }
        self.stats = {"allocs": 0, "frees": 0, "failed": 0}

    # ------------------------------------------------------------------ #

    def _group_with_space(self, nrows: int, exclude: Iterable[int] = ()) -> Optional[int]:
        excl = set(exclude)
        best: Optional[int] = None
        best_free = -1
        for gid, g in self._groups.items():
            if gid in excl:
                continue
            if len(g.free) >= nrows and len(g.free) > best_free:
                best, best_free = gid, len(g.free)
        return best

    def alloc(
        self,
        nrows: int,
        *,
        same_group_as: Optional[Allocation] = None,
        group: Optional[int] = None,
        tag: str = "",
    ) -> Allocation:
        """Allocate ``nrows`` rows from a single group.

        ``same_group_as`` expresses the RowClone constraint: the new rows
        are guaranteed to be in-subarray with the given allocation, so
        ``pim_copy`` between them is legal.
        """
        if same_group_as is not None:
            gid = same_group_as.group
        elif group is not None:
            gid = group
        else:
            g = self._group_with_space(nrows)
            if g is None:
                self.stats["failed"] += 1
                raise PimAllocError(f"no group with {nrows} free rows")
            gid = g

        grp = self._groups.get(gid)
        if grp is None:
            raise PimAllocError(f"unknown group {gid}")
        if len(grp.free) < nrows:
            self.stats["failed"] += 1
            raise PimAllocError(
                f"group {gid} has {len(grp.free)} free rows, need {nrows}"
                + (" (same-subarray constraint)" if same_group_as else "")
            )
        rows = tuple(grp.free[:nrows])
        del grp.free[:nrows]
        alloc = Allocation(rows=rows, group=gid, tag=tag)
        for r in rows:
            self._owner[r] = alloc
            self.coherence[r] = CoherenceState.INVALID
        self.stats["allocs"] += 1
        return alloc

    def alloc_copy_pair(self, nrows: int, tag: str = "") -> Tuple[Allocation, Allocation]:
        """Allocate src+dst operands satisfying RowClone's constraint."""
        gid = self._group_with_space(2 * nrows)
        if gid is None:
            self.stats["failed"] += 1
            raise PimAllocError(f"no group with {2 * nrows} free rows for copy pair")
        src = self.alloc(nrows, group=gid, tag=tag + ":src")
        dst = self.alloc(nrows, group=gid, tag=tag + ":dst")
        return src, dst

    def free(self, alloc: Allocation) -> None:
        grp = self._groups[alloc.group]
        for r in alloc.rows:
            if self._owner.get(r) is not alloc:
                raise PimAllocError(f"row {r} not owned by this allocation")
            del self._owner[r]
            grp.free.append(r)
            self.coherence[r] = CoherenceState.INVALID
        self.stats["frees"] += 1

    # Coherence tracking ------------------------------------------------- #

    def touch_cpu_write(self, alloc: Allocation) -> None:
        for r in alloc.rows:
            self.coherence[r] = CoherenceState.DIRTY

    def touch_cpu_read(self, alloc: Allocation) -> None:
        for r in alloc.rows:
            if self.coherence[r] is CoherenceState.INVALID:
                self.coherence[r] = CoherenceState.CLEAN

    def needs_flush(self, alloc: Allocation) -> bool:
        return any(self.coherence[r] is CoherenceState.DIRTY for r in alloc.rows)

    def mark_flushed(self, alloc: Allocation) -> None:
        for r in alloc.rows:
            self.coherence[r] = CoherenceState.CLEAN

    # Introspection ------------------------------------------------------ #

    def free_rows(self, gid: Optional[int] = None) -> int:
        if gid is not None:
            return len(self._groups[gid].free)
        return sum(len(g.free) for g in self._groups.values())

    def utilization(self) -> float:
        total = sum(g.total for g in self._groups.values())
        return 1.0 - self.free_rows() / total if total else 0.0

    @property
    def num_groups(self) -> int:
        return len(self._groups)

    def group_ids(self) -> List[int]:
        return sorted(self._groups)


def allocator_from_subarray_map(smap) -> SubarrayAllocator:
    """Build an allocator from a discovered :class:`SubarrayMap`."""
    return SubarrayAllocator({gid: rows for gid, rows in smap.members.items()})


def arena_groups(num_slabs: int, pages_per_slab: int) -> Dict[int, List[int]]:
    """Row groups for a device arena: slab s owns pages [s*P, (s+1)*P)."""
    return {
        s: list(range(s * pages_per_slab, (s + 1) * pages_per_slab))
        for s in range(num_slabs)
    }
