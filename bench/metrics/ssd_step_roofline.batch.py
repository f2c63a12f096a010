"""The decode step's SSD state update's least time for the traced
slice's decode rows (each row's float32 state read once and its new
state written once, over every SSM layer; the rows as served, without
the batch's pad rows), the traced card's share of it, over the
profiler's time for the ``ssd_step`` kernel."""

from bench import counts
from bench.trace import group_time


def read(w):
    t = group_time(w.slice, "ssd_step")
    if t is None:
        return None
    rows = sum(len(c.contexts) for c in w.slice_calls)
    return 100.0 * counts.least_seconds(counts.ssd_step(w.model, rows),
                                        w.chips)[0] / t
