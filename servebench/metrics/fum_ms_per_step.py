"""Device milliseconds of the FUM decode kernels (split pass and merge)
per decode step of the batch, from the profiler slice."""


def read(w):
    t = w.trace
    if not t or not t["decode_steps"] or not t["fum_s"]:
        return None
    return 1e3 * t["fum_s"] / t["decode_steps"]
