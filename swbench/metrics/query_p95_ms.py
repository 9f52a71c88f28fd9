"""query_p95_ms: the 95th percentile of the window's query times, each
from the call of ``SearchEngine.scan`` to its top hits on the host
(``statistics.quantiles``' exclusive method); none where the window timed
no single query."""

import statistics


def read(run):
    lat = run.window.latencies
    return statistics.quantiles(lat, n=20)[18] * 1e3 if len(lat) >= 20 else None
