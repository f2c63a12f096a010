"""Host milliseconds of a pure decode round (rounds and K-block rounds;
each ends in its token transfer, so the time holds the device's work):
``decode_seconds`` over the rounds that were not mixed."""


def read(w):
    rounds = w.d("decode_rounds") - w.d("mixed_dispatches")
    return 1e3 * w.d("decode_seconds") / rounds if rounds > 0 else None
