"""Flash attention's least time for the traced slice's prefill chunks
(queries causal over themselves and their committed prefix, at the
chunks' real lengths), the traced card's share of it, over the
profiler's time for the flash kernels."""

from bench import counts
from bench.trace import group_time


def read(w):
    t = group_time(w.slice, "flash_attention")
    if t is None:
        return None
    # one launch a layer covers a step's chunk rows: the bound of their
    # summed work
    least = sum(counts.least_seconds(counts.add(
        *(counts.flash_prefix(w.model, q, p) for q, p in c.chunks)),
        w.chips)[0]
        for c in w.slice_calls if c.chunks)
    return 100.0 * least / t if least else None
