"""The model's operations for the window's tokens (prefill chunks and
decode rows, attention over the real lengths), over the window's
seconds, as a share of the dense bf16 peak of the cell's H100s."""

from bench import counts


def read(w):
    if not w.calls:
        return None
    flops = sum(c.work(w.model)[0] for c in w.calls)
    return 100.0 * flops / (counts.PEAK_FLOPS * w.chips) / w.seconds
