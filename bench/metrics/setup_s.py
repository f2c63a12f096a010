"""Process start to the window's first timed step: weights, engine and
arenas, kernel builds on a checkout's first run, and the warm-up of the
cell's own traffic (graph captures included)."""


def read(w):
    return w.setup_s
