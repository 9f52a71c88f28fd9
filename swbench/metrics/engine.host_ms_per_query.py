"""engine.host_ms_per_query: the mean over the window's queries of the
query's time (its ``swbench:query`` range in the trace) less the time
inside it in which the card ran a kernel or a copy, in ms: what the host
adds to a query."""

from swbench.trace import overlap


def read(run):
    tr = run.trace
    spans = tr.span_list("swbench:query") if tr else []
    if not spans or not tr.devices:
        return None
    busy = tr.busy(tr.devices[0])
    return sum((b - a) - overlap(busy, a, b) for a, b in spans) / len(spans) / 1e6
