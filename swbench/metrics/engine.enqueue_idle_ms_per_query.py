"""engine.enqueue_idle_ms_per_query: the card's idle time while the host
was inside the engine's ``sw:enqueue`` ranges (a single scan's query
upload, bucket launches, slot concatenation and top N), over the window's
queries, in ms (``swbench.idle``)."""

from swbench.idle import idle_ms_per_query


def read(run):
    return idle_ms_per_query(run, ("sw:enqueue",))
