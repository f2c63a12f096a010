"""The least time of the window's engine calls (each the larger of its
operations at the bf16 peak and its bytes at the HBM rate, weights read
once a step, K/V or state at the real lengths) on the cell's cards,
over the window's seconds."""

from bench import counts


def read(w):
    if not w.calls:
        return None
    least = sum(counts.least_seconds(c.work(w.model), w.chips)[0] for c in w.calls)
    return 100.0 * least / w.seconds
