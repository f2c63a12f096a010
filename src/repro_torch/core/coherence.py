"""Cache-coherence maintenance model (PiDRAM SS2 / SS5).

PiM source operands must be up to date in DRAM.  On the prototype this
means a CLFLUSH-style operation per cache block of the operand; the paper
shows this collapses RowClone's 118.5x copy speedup to 14.6x.  This module
gives the framework a first-class coherence policy object so end-to-end
paths (benchmarks, the serving engine's page manager) charge the right
cost and so policies can be compared (the paper points at Dirty-Block
Index-style trackers as the fix; we model that as `PRECISE`).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from .allocator import Allocation, CoherenceState, SubarrayAllocator
from .memctrl import MemoryController


class CoherencePolicy(enum.Enum):
    #: No tracking: every PiM op conservatively flushes all operand blocks
    #: (the paper's "coherence" rows: 14.6x / 12.6x).
    CONSERVATIVE = "conservative"
    #: Perfect dirty tracking (Dirty-Block-Index-like): flush only when the
    #: allocator observed a CPU write since the last flush (118.5x rows when
    #: operands are PiM-private).
    PRECISE = "precise"
    #: Never flush — only valid when the software contract guarantees
    #: operands are never CPU-cached (e.g. arenas resident on the card).
    NONE = "none"


@dataclass
class CoherenceModel:
    policy: CoherencePolicy
    mc: MemoryController

    def flush_cost_ns(self, alloc: Allocation, allocator: SubarrayAllocator, *, write_back: bool = True) -> float:
        nbytes = alloc.nrows * self.mc.proto.row_bytes
        if self.policy is CoherencePolicy.NONE:
            return 0.0
        if self.policy is CoherencePolicy.CONSERVATIVE:
            return self.mc.clflush_ns(nbytes) if write_back else self.mc.clinval_ns(nbytes)
        # PRECISE: charge only if the allocator saw dirty state.
        if allocator.needs_flush(alloc):
            allocator.mark_flushed(alloc)
            return self.mc.clflush_ns(nbytes) if write_back else self.mc.clinval_ns(nbytes)
        return 0.0
