"""Share of the profiler slice in which no kernel ran on the card, in %."""


def read(w):
    t = w.trace
    if not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
