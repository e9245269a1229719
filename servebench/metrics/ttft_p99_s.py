"""99th percentile of the time to first token (``Result.ttft_s``: submit
to the host read that returned the first token) over every request sent
inside the window; a request that did not finish with status "ok"
counts as missing any limit (an infinite time)."""
import math

import numpy as np


def read(w):
    vals = [r.result.ttft_s if r.result is not None and r.result.status == "ok"
            and r.result.ttft_s is not None else math.inf for r in w.counted]
    if not vals:
        return None
    v = float(np.percentile(vals, 99))
    # interpolating towards a missing request's infinite time gives NaN
    return math.inf if math.isnan(v) else v
