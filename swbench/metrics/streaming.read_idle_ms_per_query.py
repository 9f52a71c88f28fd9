"""streaming.read_idle_ms_per_query: the card's idle time while the host
read streamed chunks into page-locked memory (the ``sw:stream_read``
ranges, the interval that ``streaming.host_copy_ms_per_query`` sums), over
the window's queries, in ms (``swbench.idle``); none where nothing
streamed."""

from swbench.idle import idle_ms_per_query


def read(run):
    return idle_ms_per_query(run, ("sw:stream_read",))
