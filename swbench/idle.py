"""Where the host was while the card sat idle: the per-layer metrics that
split a query's host time by the engine's own ranges (``sw:*``, see
``cudasw4_tpu_torch/engine.py`` and ``engine_streaming.py``) read it here.

A range is picked by its name's first word (``sw:bucket`` picks every
``sw:bucket <kind> L=<L>``).  "Idle inside ranges S" is the union of the
window's S ranges less its overlap with the fullest-loaded card's busy
time (kernels and copies), cut to the window, over the window's answered
queries, in ms.  Every helper returns None where the trace holds no such
range or no device event.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right

from swbench.trace import measure, merge, overlap


def _covered(disjoint, starts, a: int, b: int) -> int:
    """``overlap(disjoint, a, b)`` over only the intervals that can meet
    [a, b) (``starts``: their starts), so that a window of hundreds of
    thousands of kernels and ranges reads in n log n."""
    return overlap(disjoint[max(0, bisect_right(starts, a) - 1) : bisect_left(starts, b)], a, b)


def ranges(run, names, within: str | None = None) -> list[tuple[int, int]]:
    """The union, cut to the window, of the host ranges whose name's first
    word is in ``names``; with ``within``, only those that lie inside a
    range of that name.  Empty without a trace or an answered query."""
    tr = run.trace
    if tr is None or not run.window.answers:
        return []
    picked = [(a, b) for a, b, n in tr.spans if n.split(" ")[0] in names]
    if within is not None:
        outer = merge(tr.span_list(within))
        starts = [a for a, _ in outer]
        picked = [(a, b) for a, b in picked if _covered(outer, starts, a, b) == b - a]
    return merge(tr.clipped(picked))


def idle_ms_per_query(run, names, within: str | None = None) -> float | None:
    """Idle inside the ranges of ``names`` (see the module docstring)."""
    spans = ranges(run, names, within)
    dev = run.trace.busiest() if spans else None
    if dev is None:
        return None
    busy = run.trace.clipped(run.trace.busy(dev))
    starts = [a for a, _ in busy]
    idle = sum((b - a) - _covered(busy, starts, a, b) for a, b in spans)
    return idle / len(run.window.answers) / 1e6


def host_ms_per_query(run, names) -> float | None:
    """The host's time inside the ranges of ``names``, busy card or not,
    over the window's answered queries, in ms; None also off the card."""
    spans = ranges(run, names)
    if not spans or not run.trace.devices:
        return None
    return measure(spans) / len(run.window.answers) / 1e6
