"""streaming.enqueue_idle_ms_per_query: the card's idle time while the
host enqueued a streamed pass's chunk work (``sw:unpack``, ``sw:bucket``,
``sw:batch_bucket`` and ``sw:top_n`` ranges inside ``sw:stream_pass``),
over the window's queries, in ms (``swbench.idle``); none where nothing
streamed."""

from swbench.idle import idle_ms_per_query


def read(run):
    return idle_ms_per_query(run, ("sw:unpack", "sw:bucket", "sw:batch_bucket", "sw:top_n"),
                             within="sw:stream_pass")
