"""streaming.slot_wait_ms_per_query: the host's time blocked waiting for a
staging slot's previous copy (the ``sw:stream_wait`` ranges of a streamed
pass), busy card or not, over the window's queries, in ms
(``swbench.idle``); none where nothing streamed."""

from swbench.idle import host_ms_per_query


def read(run):
    return host_ms_per_query(run, ("sw:stream_wait",))
