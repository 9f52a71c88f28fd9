"""The readers of the engine's own ranges (``swbench.idle``) on hand-built
traces: the card's idle time inside the ranges counts, its busy time and
what lies outside the window do not, and a reader finds nothing where its
ranges are absent."""

from __future__ import annotations

import types

import pytest

from swbench import run
from swbench.trace import Trace

MS = 1_000_000  # ns

#: Each new reader, the range it reads, and whether it counts idle time
#: only (the slot wait counts the host's time, busy card or not).
READERS = [
    ("engine.enqueue_idle_ms_per_query", "sw:enqueue", True),
    ("engine.finish_idle_ms_per_query", "sw:finish", True),
    ("streaming.read_idle_ms_per_query", "sw:stream_read", True),
    ("streaming.enqueue_idle_ms_per_query", "sw:bucket cell L=64", True),
    ("streaming.enqueue_idle_ms_per_query", "sw:batch_bucket col L=1024", True),
    ("streaming.enqueue_idle_ms_per_query", "sw:unpack", True),
    ("streaming.enqueue_idle_ms_per_query", "sw:top_n", True),
    ("streaming.slot_wait_ms_per_query", "sw:stream_wait", False),
]
NAMES = sorted({r[0] for r in READERS})


def _run(spans, kernels=(), copies=(), answers=2, window=(0, 100)):
    """A run whose trace holds ``spans`` [(a, b, name)], kernels and copies
    on card 0 [(a, b)], all in ms, a window of 0-100 ms and ``answers``
    answered queries."""
    tr = Trace(window_ns=(window[0] * MS, window[1] * MS))
    tr.spans = [(a * MS, b * MS, n) for a, b, n in spans]
    for a, b in kernels:
        tr.kernels[0].append((a * MS, b * MS, "sw_cell_kernel"))
    for a, b in copies:
        tr.copies[0].append((a * MS, b * MS, "Memcpy HtoD (Pinned -> Device)"))
    return types.SimpleNamespace(trace=tr, window=types.SimpleNamespace(answers=[None] * answers))


@pytest.mark.parametrize("metric,name,idle_only", READERS)
def test_idle_inside_ranges_counts(metric, name, idle_only):
    """Ranges of 10-30 ms (a kernel at 15-20, a copy at 25-27), -10-5 and
    95-110 ms (cut to the 0-100-ms window), inside a streamed pass; a range
    of another name, idle at 40-60 ms, and a card busy outside the
    ranges, add nothing."""
    spans = [(-50, 150, "sw:stream_pass"), (10, 30, name), (-10, 5, name), (95, 110, name),
             (40, 60, "sw:scan")]
    r = _run(spans, kernels=[(15, 20), (60, 90)], copies=[(25, 27), (31, 33)])
    want = (20 - 5 - 2 + 5 + 5) / 2 if idle_only else (20 + 5 + 5) / 2
    assert run.read_metric(metric, r) == pytest.approx(want)


def test_overlapping_ranges_count_once():
    """A streamed chunk's ranges nest and abut: their union counts once,
    and a bucket range outside every pass is not the pass's."""
    spans = [(0, 50, "sw:stream_pass"), (5, 10, "sw:unpack"), (10, 30, "sw:batch_bucket cell L=64"),
             (12, 18, "sw:bucket cell L=64"), (30, 35, "sw:top_n"), (60, 70, "sw:bucket row L=32")]
    r = _run(spans, kernels=[(40, 45)], answers=3)
    assert run.read_metric("streaming.enqueue_idle_ms_per_query", r) == pytest.approx(30 / 3)


RESIDENT = [(0, 50, "sw:scan"), (0, 20, "sw:enqueue"), (2, 8, "sw:bucket cell L=64"),
            (20, 50, "sw:finish")]
STREAMED = [(0, 60, "sw:scan"), (0, 50, "sw:stream_pass"), (1, 2, "sw:stream_wait"),
            (2, 9, "sw:stream_read"), (9, 10, "sw:unpack"), (10, 20, "sw:batch_bucket cell L=64"),
            (20, 21, "sw:top_n"), (40, 50, "sw:readback"), (50, 60, "sw:finish")]


def test_readers_find_nothing_where_their_ranges_are_absent():
    """The streaming readers on a resident run, ``sw:enqueue`` on a streamed
    one, and every reader without a trace, a card's events or an answer."""
    def read(r):
        return {m: run.read_metric(m, r) for m in NAMES}

    resident = read(_run(RESIDENT, kernels=[(8, 12)]))
    assert {m for m, v in resident.items() if v is not None} == {
        "engine.enqueue_idle_ms_per_query", "engine.finish_idle_ms_per_query"}
    assert resident["engine.enqueue_idle_ms_per_query"] == pytest.approx(16 / 2)
    streamed = read(_run(STREAMED, kernels=[(12, 30)]))
    assert {m for m, v in streamed.items() if v is None} == {"engine.enqueue_idle_ms_per_query"}
    assert streamed["streaming.read_idle_ms_per_query"] == pytest.approx(7 / 2)
    assert streamed["streaming.slot_wait_ms_per_query"] == pytest.approx(1 / 2)
    assert streamed["streaming.enqueue_idle_ms_per_query"] == pytest.approx(3 / 2)
    for r in (_run(STREAMED), _run(STREAMED, kernels=[(12, 30)], answers=0),
              types.SimpleNamespace(trace=None, window=types.SimpleNamespace(answers=[None]))):
        assert set(read(r).values()) == {None}


def test_covered_equals_overlap():
    """The readers' bounded ``overlap`` gives the whole list's, on ranges
    that start and end inside, between and across busy intervals."""
    import random

    from swbench.idle import _covered
    from swbench.trace import merge, overlap

    rng = random.Random(7)
    busy = merge((a, a + rng.randrange(1, 30)) for a in rng.sample(range(5000), 300))
    starts = [a for a, _ in busy]
    for _ in range(2000):
        a = rng.randrange(-50, 5100)
        b = a + rng.randrange(0, 200)
        assert _covered(busy, starts, a, b) == overlap(busy, a, b)
