"""Paged attention's least time for the traced slice's decode rows
(K/V of every key read once, at the real lengths), the traced card's
share of it, over the profiler's time for the paged-attention kernels."""

from bench import counts
from bench.trace import group_time


def read(w):
    t = group_time(w.slice, "paged_attention")
    if t is None:
        return None
    least = sum(counts.least_seconds(counts.paged_attention(
        w.model, c.contexts), w.chips)[0]
        for c in w.slice_calls if c.contexts)
    return 100.0 * least / t
