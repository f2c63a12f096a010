"""Share of the traced slice in which no kernel or copy ran on the
device (the union of device events, from the profiler)."""


def read(w):
    sl = w.slice
    if sl is None or sl.window_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
