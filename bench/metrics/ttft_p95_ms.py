"""95th percentile, over every request due in the window, of the time
from its due time to its first token; a request that never finished
counts at the time the run stopped waiting for it."""

from bench.harness import percentile


def read(w):
    vals = []
    for lv in w.requests:
        s = lv.stream
        ok = s is not None and not s.rejected and s.finished_ms is not None
        vals.append(s.first_token_ms - lv.due_ms if ok else w.missing_ms)
    return percentile(vals, 95)
