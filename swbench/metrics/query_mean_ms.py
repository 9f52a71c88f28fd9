"""query_mean_ms: the mean of the window's query times, each from the call
of ``SearchEngine.scan`` to its top hits on the host, over every query of
the window; under closed arrivals it is the window's seconds over its
queries, the inverse of its rate.  None where the window timed no single
query."""


def read(run):
    lat = run.window.latencies
    return sum(lat) / len(lat) * 1e3 if lat else None
