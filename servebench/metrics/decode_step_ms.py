"""Milliseconds per decode step of the whole batch: the delta of the
engine's ``decode_s`` (host clock around each horizon of graph replays,
ending in the history read) over the delta of ``decode_steps``."""


def read(w):
    steps = w.delta("decode_steps")
    return 1e3 * w.delta("decode_s") / steps if steps else None
