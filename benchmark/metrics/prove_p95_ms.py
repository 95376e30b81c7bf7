"""prove_p95_ms: the 95th percentile of every proof's latency in the window,
each from the call to its proof in host memory, in milliseconds."""

import statistics


def read(run):
    lat = run.window.latencies
    if len(lat) < 2:
        return None
    return 1e3 * statistics.quantiles(lat, n=20, method="inclusive")[18]
