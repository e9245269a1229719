"""Process start to the window's start: imports, weights drawn on the
card, the engine and its pool, the warm-up of the cell's prefill shapes
and decode graph (and, in a checkout's first run, the kernels' build),
and the load's ramp."""


def read(w):
    return w.setup_s
