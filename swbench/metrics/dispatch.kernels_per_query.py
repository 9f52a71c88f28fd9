"""dispatch.kernels_per_query: the device kernels that started in the
window (Smith-Waterman's and PyTorch's: top N, masks, unpack), over the
queries answered in it."""


def read(run):
    tr = run.trace
    if tr is None or not run.window.answers:
        return None
    w0, w1 = tr.window_ns
    n = sum(1 for evs in tr.kernels.values() for a, _, _ in evs if w0 <= a < w1)
    return n / len(run.window.answers) if n else None
