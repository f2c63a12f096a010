"""95th percentile of every gap between consecutive tokens of every
request due in the window (the front door publishes a round's tokens
when the round ends, so a gap is a round as the client sees it)."""

from bench.harness import percentile


def read(w):
    return percentile([g for lv in w.requests if lv.stream is not None
                       for g in lv.stream.itl_ms()], 95)
