"""streaming.host_copy_ms_per_query: the host's milliseconds reading
streamed chunks into page-locked memory (``stream_copy_stats()
["host_copy_ms"]`` after each streamed pass), over the window's queries;
none where nothing streamed."""


def read(run):
    ms = run.window.host_copy_ms
    return sum(ms) / len(ms) if ms else None
