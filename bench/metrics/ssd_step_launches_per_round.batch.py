"""Launches of the decode step's SSD state update (``ssd_step``, one a
Mamba sublayer a decode forward) a decode round, over the window.  None
where the program counts no such launch (a program without the
kernel)."""


def read(w):
    rounds = w.d("decode_rounds")
    if not rounds or not w.calls or "ssd_step" not in w.calls[-1].launches1:
        return None
    return w.launches("ssd_step") / rounds
