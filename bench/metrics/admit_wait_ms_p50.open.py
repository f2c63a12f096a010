"""Median time from a window request's due time to its admission into
the engine by the front door (``TokenStream.admitted_ms``); a request
never admitted counts as missing."""

from bench.harness import percentile


def read(w):
    vals = [(lv.stream.admitted_ms - lv.due_ms
             if lv.stream.admitted_ms is not None else w.missing_ms)
            for lv in w.requests if lv.stream is not None]
    return percentile(vals, 50)
