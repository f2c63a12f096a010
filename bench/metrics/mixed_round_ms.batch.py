"""Host milliseconds of a mixed round (a chunk batch and the decode
rows in one fused step, ending in its token transfer, so the time holds
the device's work): ``mixed_seconds`` (the program's
``engine.mixed_round`` span) over ``mixed_dispatches``; the rounds
``decode_round_ms`` leaves out.  Nothing where the program keeps no such
total."""


def read(w):
    if not w.calls or "mixed_seconds" not in w.calls[0].stats0:
        return None
    rounds = w.d("mixed_dispatches")
    return 1e3 * w.d("mixed_seconds") / rounds if rounds > 0 else None
