"""req_p95_ms: the 95th percentile of every request's latency in the
window, issue to completion (host clock ending in a synchronize)."""

import numpy as np


def read(r):
    return float(np.percentile(np.asarray(r.latencies_s) * 1e3, 95))
