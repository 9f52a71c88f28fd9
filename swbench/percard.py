"""Each card's time in the engine's Smith-Waterman kernels in one traced
run of a cell.

    python -m swbench.percard --workload <cell> --seed <n> --seconds <s>

Runs the cell as ``swbench.run`` does with ``--trace 1`` (its result line
on standard output, its notes on standard error), then prints one more
JSON line: for each card of the trace, the seconds within the measured
window in kernels named ``sw_*`` (the kernels ``parallel.shard_imbalance``
compares), and the same over the window's queries, from the result line's
``attempted``.
"""

from __future__ import annotations

import contextlib
import io
import json
import sys

from . import run, trace as tracing


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    traces = []
    from_profiler = tracing.from_profiler

    def keep(prof):
        traces.append(from_profiler(prof))
        return traces[-1]

    tracing.from_profiler = keep
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = run.main(argv + ["--trace", "1"])
    finally:
        tracing.from_profiler = from_profiler
    sys.stdout.write(out.getvalue())
    if rc or not traces:
        return rc or 1
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    tr, queries = traces[0], result["attempted"]
    cards = {d: tracing.measure(tr.clipped(tr.kernel_busy(d, "sw_"))) / 1e9 for d in tr.devices}
    print(json.dumps({"sw_s": cards, "queries": queries,
                      "sw_ms_per_query": {d: 1e3 * s / queries for d, s in cards.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
