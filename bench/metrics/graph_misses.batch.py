"""First uses of a step shape key inside the window (the step cache
runs those eagerly, and captures on the second): the four retrace
counters of ``PagedEngine.stats``."""

from bench.harness import MISS_KEYS


def read(w):
    return sum(w.d(k) for k in MISS_KEYS) if w.calls else None
