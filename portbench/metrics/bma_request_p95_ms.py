"""``bma_request_p95_ms``: the 95th percentile (linear between order
statistics) of every request's latency in the window, from its issue to its
logits on the host, in milliseconds."""

import numpy as np


def read(run):
    lat = run.window.get("latencies")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95)) * 1e3
