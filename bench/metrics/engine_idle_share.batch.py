"""Share of the traced slice in which no device event runs while the
engine's thread is inside ``engine.run`` and outside every
``device.wait`` (the program's spans, laid over the slice by
``bench/spans.py``): the idle the program's host work causes.  Nothing
where the program records no spans."""

from bench import spans


def read(w):
    sl = w.slice
    if sl is None or sl.window_s <= 0:
        return None
    laid = spans.lay(sl)
    if laid is None:
        return None
    return 100.0 * laid.engine_idle_us() / 1e6 / sl.window_s
