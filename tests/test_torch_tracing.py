"""The port's profiler spans and scan seconds on the CPU.

A resident scan, a streamed scan (one-tile chunks under a budget of one
byte, or of a pass's working memory and a third of the tiles, so that a
resident prefix leads the pass) and ``scan_many`` run under a CPU
``torch.profiler``.  Their ``sw:*`` ranges must form the tree that
``engine.py`` and ``engine_streaming.py`` describe, in that order, with no
two ranges partly overlapping; ``sw:stream_read`` once a streamed chunk;
nothing recorded with no profiler running.  ``scan_many``'s seconds follow
the host clock (a stubbed one): from the later of a launch and the
previous result's arrival to the result on the host.
"""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cudasw4_tpu_torch import engine as engine_mod
from cudasw4_tpu_torch.db.format import DBData
from cudasw4_tpu_torch.engine import SearchEngine
from cudasw4_tpu_torch.engine_streaming import stream_work_bytes
from cudasw4_tpu_torch.ops import sw_cell
from cudasw4_tpu_torch.parallel.sharding import make_mesh

#: Queries longer than this run as singles (QCAP_BATCH lowered).
QCAP_BATCH = 64

#: scan_many's queries: batches of the short ones, singles of the rest.
MANY = (10, 20, 300, 15, 400, 30, 70)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _short_batches(monkeypatch):
    monkeypatch.setattr(sw_cell, "QCAP_BATCH", QCAP_BATCH)


@pytest.fixture(scope="module")
def db():
    """600 random sequences of 5-129 aa: eight row buckets by default."""
    rng = np.random.default_rng(5)
    lens = np.sort(rng.integers(5, 130, size=600)).astype(np.int32)
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum((lens + 3) // 4 * 4, out=offsets[1:])
    chars = np.full(int(offsets[-1]), 20, np.int8)
    for a, n in zip(offsets[:-1], lens):
        chars[a : a + n] = rng.integers(0, 20, size=int(n))
    return DBData(chars=chars, offsets=offsets.astype(np.uint64), lengths=lens,
                  headers=np.zeros(0, np.uint8), header_offsets=np.zeros(len(lens) + 1, np.uint64))


def _queries(lengths, seed=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 20, size=n).astype(np.int8) for n in lengths]


def _engine(db, prefix=None, **kw):
    """A resident engine, or with ``prefix`` a streamed one of one-tile
    chunks: no resident prefix (False) or one of a third of the tiles."""
    if prefix is not None:
        kw.update(max_device_bytes=1, stream_chunk_bytes=4096)
    eng = SearchEngine(num_top=5, device=kw.pop("device", "cpu"), **kw)
    if prefix:
        eng.set_database(db)
        shapes = [(b.L, b.NS, b.kernel, b.num_tiles) for b in eng.packed.buckets]
        eng.max_device_bytes = (stream_work_bytes(shapes, 4096, None, eng.QB_STREAM)[0]
                                + eng.packed.total_padded_chars // 3)
    eng.set_database(db)
    assert eng.streaming == (prefix is not None)
    assert bool(eng._resident_chunks) == bool(prefix)
    return eng


def _traced(fn):
    """(fn()'s value, the ``sw:*`` ranges recorded while it ran, as
    (start ns, end ns, name) by start, outer ranges first)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
             for e in prof.profiler.kineto_results.events() if e.name().startswith("sw:")]
    return out, sorted(spans, key=lambda s: (s[0], -s[1]))


def _tree(spans) -> list:
    """The ranges as nested (name, [children]) in order; fails where two
    ranges partly overlap."""
    root: list = []
    stack = [(float("inf"), root)]
    for a, b, name in spans:
        while stack[-1][0] <= a:
            stack.pop()
        assert b <= stack[-1][0], f"{name} [{a}, {b}) partly overlaps its enclosing range"
        children: list = []
        stack[-1][1].append((name, children))
        stack.append((b, children))
    return root


def _leaf(name):
    return (name, [])


def _buckets(eng, prefix: str = "sw:bucket"):
    return [_leaf(f"{prefix} {b.kernel} L={b.L}") for b in eng.packed.buckets]


def _pass(eng, qlens):
    """The expected tree of one streamed pass of queries of ``qlens``."""
    kernels = []
    for n in qlens:
        kernels.append("sw:batch_bucket" if n <= eng._qcap_batch else "sw:bucket")
    kernels = list(dict.fromkeys(kernels))  # one batch span for every short query

    def scored(b):
        return [_leaf(f"{k} {b.kernel} L={b.L}") for k in kernels] + [_leaf("sw:top_n")]

    chunks = []
    for bi, *_ in eng._resident_chunks:
        chunks += scored(eng.packed.buckets[bi])
    for bi, *_ in eng._stream_chunks():
        chunks += [_leaf("sw:stream_wait"), _leaf("sw:stream_read"), _leaf("sw:unpack")]
        chunks += scored(eng.packed.buckets[bi])
    return [("sw:stream_pass", chunks + [_leaf("sw:readback")]), _leaf("sw:finish")]


def test_resident_scan_spans(db):
    eng = _engine(db)
    q = _queries([40])[0]
    want = eng.scan(q)
    got, spans = _traced(lambda: eng.scan(q))
    assert (got.scores, got.reference_ids) == (want.scores, want.reference_ids)
    assert _tree(spans) == [("sw:scan", [("sw:enqueue", _buckets(eng)), _leaf("sw:finish")])]


@pytest.mark.parametrize("prefix", [False, True])
def test_streamed_scan_spans(db, prefix):
    resident, eng = _engine(db), _engine(db, prefix=prefix)
    q = _queries([40])[0]
    got, spans = _traced(lambda: eng.scan(q))
    want = resident.scan(q)
    assert (got.scores, got.reference_ids) == (want.scores, want.reference_ids)
    assert _tree(spans) == [("sw:scan", _pass(eng, [40]))]
    reads = sum(1 for *_, n in spans if n == "sw:stream_read")
    assert reads == eng.stream_copy_stats()["chunks"] > 0


def test_streamed_scan_many_spans(db):
    """A streamed pass of a short and a long query: a batch span and a
    single's span on every chunk, and no ``sw:scan`` root."""
    eng = _engine(db, prefix=False)
    qs = _queries([30, 100])
    got, spans = _traced(lambda: list(eng.scan_many(qs)))
    assert _tree(spans) == _pass(eng, [30, 100])
    assert [r.scores for r in got] == [_engine(db).scan(q).scores for q in qs]


def test_scan_many_spans(db):
    """Batches keep ``sw:scan_batch`` and ``sw:batch_bucket`` (chip_smoke's
    PROFILE_SPANS read them); singles are ``sw:enqueue`` then ``sw:finish``,
    each launch's ``sw:finish`` after up to ``window`` launches ahead."""
    eng = _engine(db)
    qs = _queries(MANY)
    got, spans = _traced(lambda: list(eng.scan_many(qs, window=3)))
    assert [r.scores for r in got] == [eng.scan(q).scores for q in qs]
    batch = ("sw:scan_batch", _buckets(eng, "sw:batch_bucket"))
    single = ("sw:enqueue", _buckets(eng))
    finish = _leaf("sw:finish")
    # [10, 20] | 300 | [15] | 400 | [30] | 70: the fourth and the sixth
    # launch each read one back, the rest come back at the end
    assert _tree(spans) == [batch, single, batch, single, finish, batch, single,
                            finish, finish, finish, finish, finish]


def test_no_profiler_records_nothing(db, monkeypatch):
    """With no profiler running a span is a flag check: no profiler range
    is opened (and on the CPU no NVTX range either)."""
    opened = []
    real = torch.profiler.record_function

    def spy(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    q = _queries([40])[0]
    for eng in (_engine(db), _engine(db, prefix=True)):
        eng.scan(q)
        list(eng.scan_many(_queries(MANY)))
    assert opened == []
    _traced(lambda: eng.scan(q))
    assert "sw:scan" in opened and "sw:stream_read" in opened


class _Clock:
    """A stubbed ``time`` module whose clock moves one second a read and
    logs each read with its reader: a launch (``scan_many`` or
    ``flush_shorts``) or a result on the host (``_seconds``)."""

    def __init__(self):
        self.now = 100.0
        self.reads: list = []

    def perf_counter(self):
        import sys

        self.now += 1.0
        self.reads.append((sys._getframe(1).f_code.co_name, self.now))
        return self.now


@pytest.mark.parametrize("window", [1, 3])
@pytest.mark.parametrize("shards", [0, 2])
def test_scan_many_seconds_are_host_clock(db, monkeypatch, window, shards):
    """Fault C2: each launch's seconds (a batch's summed over its queries)
    run from the later of its launch and the previous result's arrival to
    its result on the host, on one device and on a mesh; a call's
    per-query seconds sum to at most its wall time."""
    eng = _engine(db, mesh=make_mesh(["cpu"] * shards) if shards else None)
    clock = _Clock()
    monkeypatch.setattr(engine_mod, "time", types.SimpleNamespace(perf_counter=clock.perf_counter))
    finish = eng._finish_single

    def slow_finish(*args):  # the card's time: the host waits for the result
        clock.now += 7.0
        return finish(*args)

    monkeypatch.setattr(eng, "_finish_single", slow_finish)
    start = clock.perf_counter()
    got = list(eng.scan_many(_queries(MANY), window=window))
    wall = clock.perf_counter() - start
    launches = [t for who, t in clock.reads if who in ("scan_many", "flush_shorts")]
    arrivals = [t for who, t in clock.reads if who == "_seconds"]
    assert len(launches) == len(arrivals) == 6  # three batches, three singles
    want, prev = [], 0.0
    for t0, t1 in zip(launches, arrivals):
        want.append(t1 - max(t0, prev))
        prev = t1
    # results come in launch order: group each batch's queries
    sizes = [2, 1, 1, 1, 1, 1]
    k, per_launch = 0, []
    for n in sizes:
        per_launch.append(sum(r.stats.seconds for r in got[k : k + n]))
        k += n
    assert per_launch == pytest.approx(want)
    assert sum(r.stats.seconds for r in got) <= wall
    assert min(want) > 0 and all(r.stats.gcups > 0 for r in got)
