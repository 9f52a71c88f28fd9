"""streaming.streamed_share: the share of the packed tiles' bytes that
cross the link on every pass: 1 less the resident prefix's tiles over all
tiles, in %; none for a database that does not stream."""


def read(run):
    eng = run.engine
    if not getattr(eng, "streaming", False):
        return None
    buckets = eng.packed.buckets
    total = sum(b.num_tiles * b.L * b.NS for b in buckets)
    prefix = sum(eng._res_tiles.get(i, 0) * b.L * b.NS for i, b in enumerate(buckets))
    return 100.0 * (1 - prefix / total) if total else None
