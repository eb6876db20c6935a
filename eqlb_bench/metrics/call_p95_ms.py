"""call_p95_ms: the 95th percentile of the per-call latency (host clock from
the call to its sync) over every call of the window; cells of one call in
flight only."""

import numpy as np


def read(ctx):
    if ctx.traffic["in_flight"] != 1 or not ctx.latency_s:
        return None
    return 1e3 * float(np.percentile(ctx.latency_s, 95))
