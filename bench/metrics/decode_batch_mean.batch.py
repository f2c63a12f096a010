"""Mean rows a decode round served over the window: the engine's
``tokens_out`` over its ``decode_rounds`` (a mixed round is one)."""


def read(w):
    rounds = w.d("decode_rounds")
    return w.d("tokens_out") / rounds if rounds else None
