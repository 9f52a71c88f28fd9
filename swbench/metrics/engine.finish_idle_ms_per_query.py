"""engine.finish_idle_ms_per_query: the card's idle time while the host
was inside the engine's ``sw:finish`` ranges (a scan's read-back, overflow
re-score, wait for the card and result), over the window's queries, in ms
(``swbench.idle``)."""

from swbench.idle import idle_ms_per_query


def read(run):
    return idle_ms_per_query(run, ("sw:finish",))
