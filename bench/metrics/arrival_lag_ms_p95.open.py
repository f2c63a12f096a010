"""95th percentile of how late the load generator submitted each window
request after its due time: the event loop submits only between engine
rounds."""

from bench.harness import percentile


def read(w):
    return percentile([lv.submit_ms - lv.due_ms for lv in w.requests
                       if lv.stream is not None], 95)
