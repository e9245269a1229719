"""Mean queue wait (``Result.queue_wait_s``: submit to slot activation,
the wait for admission and the prefill) of the requests sent inside the
window that finished "ok", in milliseconds."""
import numpy as np


def read(w):
    vals = [r.result.queue_wait_s for r in w.counted if r.result is not None
            and r.result.status == "ok" and r.result.queue_wait_s is not None]
    return 1e3 * float(np.mean(vals)) if vals else None
