"""Host milliseconds from a drain (a wait for the card that returns with
its stream empty) to the engine's next fused-step launch, on average:
``host_gap_seconds`` over ``host_gaps`` (the program's counter, kept in
every run, with or without the profiler).  Nothing where the program
keeps no such counter."""


def read(w):
    if not w.calls or "host_gaps" not in w.calls[0].stats0:
        return None
    gaps = w.d("host_gaps")
    return 1e3 * w.d("host_gap_seconds") / gaps if gaps > 0 else None
