"""Tokens generated in the window over the window's seconds (the
engine's ``tokens_out`` counter at the window's end minus at its start):
card time per generated token, all work of the window included."""


def read(w):
    return w.delta("tokens_out") / w.seconds
