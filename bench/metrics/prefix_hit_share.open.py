"""Share of the prompt tokens handed to the engine in the window that
the radix prefix cache served (``prefix_hit_tokens``), not prefill."""


def read(w):
    if not w.calls:
        return None
    t0, t1 = w.calls[0].t0, w.calls[-1].t1
    tokens = sum(lv.prompt_len for lv in w.requests
                 if lv.engine_ms is not None and t0 <= lv.engine_ms <= t1)
    return 100.0 * w.d("prefix_hit_tokens") / tokens if tokens else None
