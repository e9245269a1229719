"""Serving prefill time per 1,000 real prompt tokens prefilled: the delta
of the engine's ``prefill_s`` (host clock around prefill work that ends
in a synchronise) over the prompt tokens, less prefix hits, of the
requests whose prefill began in the window (not the padded count)."""


def read(w):
    tokens = sum(len(r.prompt) - w.hit_tokens(r) for r in w.admitted)
    if not tokens:
        return None
    return 1e3 * w.delta("prefill_s") / (tokens / 1e3)
