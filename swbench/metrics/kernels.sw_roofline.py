"""kernels.sw_roofline: the least time the window's work could take on the
cards used (``swbench.peaks``: real cells at 4 operations, two cells a
32-bit lane operation, and each database tile byte read once a call of
the entry) over
the mean card's busy time in the engine's Smith-Waterman kernels (the
trace's kernels named ``sw_*``), in %.  None on a card without peaks or
where no such kernel ran."""

from swbench.peaks import least_seconds
from swbench.trace import measure


def read(run):
    tr = run.trace
    if tr is None:
        return None
    busy = sum(measure(tr.clipped(tr.kernel_busy(d, "sw_"))) for d in range(run.chips))
    busy /= run.chips
    tile_bytes = sum(b.num_tiles * b.L * b.NS for b in run.engine.packed.buckets)
    least = least_seconds(run.device_name, run.window.residues * run.db.residues,
                          tile_bytes * run.window.units, run.chips)
    return 100.0 * least / (busy / 1e9) if least is not None and busy else None
