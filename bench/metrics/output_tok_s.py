"""Output tokens emitted inside the window, over the window's seconds
(host clock; a closed loop's window spans whole engine calls)."""


def read(w):
    return w.tokens() / w.seconds if w.calls else None
