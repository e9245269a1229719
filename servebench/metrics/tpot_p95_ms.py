"""95th percentile of the time per output token after the first
(``Result.tpot_s``) over every request sent inside the window, in
milliseconds; a request that did not finish "ok" counts as infinite."""
import math

import numpy as np


def read(w):
    vals = [1e3 * r.result.tpot_s if r.result is not None
            and r.result.status == "ok" and r.result.tpot_s is not None
            else math.inf for r in w.counted]
    if not vals:
        return None
    v = float(np.percentile(vals, 95))
    # interpolating towards a missing request's infinite time gives NaN
    return math.inf if math.isnan(v) else v
