"""Timing and profiling (the port's counterpart of
cudasw4_tpu/utils/profiling.py).

``ScopedTimer`` prints the reference's timing line (``TIMING: <label>: <s>
s[, <g> GCUPS]``), as the JAX package's does.  ``device_trace`` is a
``torch.profiler`` session in place of the ``jax.profiler`` trace: CPU and,
where a card is present, CUDA activities, written as a Chrome trace.
``span`` marks the port's layers: an NVTX range on a CUDA device (which
``nsys`` shows) and, while a profiler runs, a ``record_function`` range
(which the Chrome trace shows); the engine puts one around each scan and
each bucket dispatch.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


class ScopedTimer:
    """A scoped wall timer; prints on exit like the reference (``TIMING:
    <label>: <s> s``), with GCUPS when given a cell count."""

    def __init__(self, label: str, cells: float | None = None, verbose: bool = True):
        self.label = label
        self.cells = cells
        self.verbose = verbose
        self.seconds = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if self.verbose:
            msg = f"TIMING: {self.label}: {self.seconds:.6g} s"
            if self.cells:
                msg += f", {self.cells / 1e9 / self.seconds:.6g} GCUPS"
            print(msg)
        return False


@contextlib.contextmanager
def device_trace(trace_dir: str | None, name: str = "trace.json"):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where a card
    is present) and write a Chrome trace to ``trace_dir/name`` on exit;
    yields that path.  A no-op yielding None when ``trace_dir`` is None."""
    if not trace_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, name)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()  # work queued before the block stays out of it
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def span(name: str, device: torch.device):
    """An NVTX range ``name`` on a CUDA ``device``, and a profiler range
    while a profiler runs (no cost beyond a flag check otherwise)."""
    nvtx = device.type == "cuda"
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        if torch.autograd._profiler_enabled():
            with torch.profiler.record_function(name):
                yield
        else:
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
