"""Launches of the page, state and scan kernels (KV scatter, RowClone
copy and init, Ambit ops and zero scan, state scatter) a decode round,
over the window."""

from bench.harness import PIM_KERNELS


def read(w):
    rounds = w.d("decode_rounds")
    if not rounds:
        return None
    return sum(w.launches(k) for k in PIM_KERNELS) / rounds
