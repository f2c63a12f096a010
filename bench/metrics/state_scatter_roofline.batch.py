"""The state scatter's least time for the rows the traced slice wrote
(each decode row and each prefill chunk row: its conv window and SSD
state read once and written once), the traced card's share of it, over
the profiler's time for the state-scatter kernel."""

from bench import counts
from bench.trace import group_time


def read(w):
    t = group_time(w.slice, "state_scatter")
    if t is None:
        return None
    rows = sum(c.d("tokens_out") + c.d("prefill_chunks")
               for c in w.slice_calls)
    return 100.0 * counts.least_seconds(
        counts.state_scatter(w.model, rows), w.chips)[0] / t
