"""recommend_p95_ms: the 95th percentile (linear interpolation) of the
host-clock latency of every ``recommend`` call in the window, in ms."""

import numpy as np


def read(run):
    lat = run.window.get("latencies")
    if not lat:
        return None
    return 1e3 * float(np.percentile(np.asarray(lat), 95))
