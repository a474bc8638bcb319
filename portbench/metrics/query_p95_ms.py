"""query_p95_ms: the 95th percentile of the window's call latencies in ms,
each on the host clock from the call into the port until its ids and
distances are on the host, over all calls of the window."""

import numpy as np


def read(run):
    if run.window.unit != "queries" or not run.window.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.window.latencies_s) * 1e3, 95))
