"""The reduction of a ``torch.profiler`` trace of the measured window.

``Trace`` holds, per card, the intervals in which a kernel ran and those
in which a copy or a memset ran (device events of the trace), and the
host's named ranges (``record_function`` spans: the harness's
``swbench:*`` around each query or pass and the engine's ``sw:*``), all in
nanoseconds on the trace's clock.  The per-layer metrics read it through
the helpers below; none of them returns a number where the trace holds
nothing to read.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

#: Prefixes of the host ranges that label the device's idle gaps.
HOST_SPANS = ("swbench:", "sw:")


def merge(intervals) -> list[tuple[int, int]]:
    """The union of ``intervals`` [(start, end)], as sorted disjoint ones."""
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def measure(intervals) -> int:
    """Total length of disjoint ``intervals``."""
    return sum(b - a for a, b in intervals)


def overlap(disjoint, a: int, b: int) -> int:
    """Length of [a, b) covered by the sorted disjoint intervals."""
    return sum(max(0, min(b, e) - max(a, s)) for s, e in disjoint if s < b and e > a)


@dataclass
class Trace:
    """Device and host events of a traced window."""

    window_ns: tuple[int, int] = (0, 0)  # the harness's window on the trace's clock
    kernels: dict = field(default_factory=lambda: defaultdict(list))  # dev -> [(a, b, name)]
    copies: dict = field(default_factory=lambda: defaultdict(list))  # dev -> [(a, b, name)]
    spans: list = field(default_factory=list)  # [(a, b, name)] host ranges

    @property
    def devices(self) -> list[int]:
        return sorted(set(self.kernels) | set(self.copies))

    def kernel_busy(self, dev: int, part: str = "") -> list[tuple[int, int]]:
        """When a kernel whose name holds ``part`` ran on card ``dev``."""
        return merge((a, b) for a, b, name in self.kernels.get(dev, ()) if part in name)

    def busy(self, dev: int) -> list[tuple[int, int]]:
        """When a kernel or a copy ran on card ``dev``."""
        return merge([(a, b) for a, b, _ in self.kernels.get(dev, ())]
                     + [(a, b) for a, b, _ in self.copies.get(dev, ())])

    def clipped(self, intervals) -> list[tuple[int, int]]:
        """``intervals`` cut to the window."""
        w0, w1 = self.window_ns
        return [(max(a, w0), min(b, w1)) for a, b in intervals if b > w0 and a < w1]

    def busiest(self) -> int | None:
        """The fullest-loaded card: the most busy time."""
        return max(self.devices, key=lambda d: measure(self.busy(d)), default=None)

    def idle_share(self) -> float | None:
        """The share of the window, in %, in which no kernel and no copy ran
        on the fullest-loaded card; None without device events."""
        dev = self.busiest()
        if dev is None:
            return None
        w0, w1 = self.window_ns
        return 100.0 * (1 - measure(self.clipped(self.busy(dev))) / (w1 - w0))

    def span_list(self, name: str) -> list[tuple[int, int]]:
        return [(a, b) for a, b, n in self.spans if n == name]

    def device_ops(self, top: int = 10) -> list:
        """[name, seconds] of the device operations that took most time,
        over every card."""
        tot: dict = defaultdict(int)
        for per in (self.kernels, self.copies):
            for evs in per.values():
                for a, b, name in evs:
                    tot[name] += b - a
        return [[n, t / 1e9] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[label, seconds] of the longest gaps on the fullest-loaded card
        in which nothing ran, each labelled by the innermost host range
        open at the gap's start (``host:none`` where none was)."""
        dev = self.busiest()
        if dev is None:
            return []
        w0, w1 = self.window_ns
        busy = self.clipped(self.busy(dev))
        edges = [w0] + [x for ab in busy for x in ab] + [w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:top]:
            open_ = [(s, n) for s, e, n in self.spans if s <= a < e]
            out.append([max(open_)[1] if open_ else "host:none", (b - a) / 1e9])
        return out


#: The harness's range around the whole measured window.
WINDOW_SPAN = "swbench:window"


def from_profiler(prof) -> Trace:
    """A ``Trace`` of a finished ``torch.profiler.profile`` session; its
    device events are those of CUDA kernels, copies and memsets, its host
    spans the ``record_function`` ranges named with ``HOST_SPANS``, and its
    window the ``WINDOW_SPAN`` range."""
    from torch.autograd import DeviceType

    tr = Trace()
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or name.startswith(HOST_SPANS):
                continue  # a host range drawn on the device's timeline
            kind = tr.copies if name.startswith(("Memcpy", "Memset")) else tr.kernels
            kind[e.device_index()].append((a, b, name))
        elif name.startswith(HOST_SPANS):
            tr.spans.append((a, b, name))
    windows = tr.span_list(WINDOW_SPAN)
    if windows:
        tr.window_ns = windows[0]
    return tr
