"""Share of the prompt tokens admitted in the window that the prefix
cache served: the delta of the radix tree's hit tokens over the real
prompt tokens of the requests whose prefill began in the window, in %."""


def read(w):
    tokens = sum(len(r.prompt) for r in w.admitted)
    if not tokens:
        return None
    return 100.0 * (w.hit1 - w.hit0) / tokens
