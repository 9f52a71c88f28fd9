"""Per-query GCUPS of one peak-sweep configuration (the port's counterpart
of tools/sweepdiag.py): where an end-to-end search of the reference's 20
query lengths loses throughput against the kernels alone.

Usage: python -m cudasw4_tpu_torch.tools.sweepdiag [L] [nseq] [--device cpu]

The database is the pseudo database of ``nseq`` copies of one random
sequence of L residues (``db.pseudo.make_pseudo_db``, default L = 1024,
nseq = 1,000,000); the queries are random sequences of the 20
``bench.QUERY_LENGTHS`` from ``np.random.default_rng(123)``, searched with
``num_top=0``.  After one scan of the shortest and of the longest query
and one warm ``scan_many`` of all 20, a timed ``scan_many`` prints one
line per query (its GCUPS and seconds: a batch's span split by each
query's cells) and a ``TOTAL`` line (all cells over the pass's wall
seconds).  Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import sys
import time

from ..bench import QUERY_LENGTHS, make_queries
from ..db.format import pseudo_to_dbdata
from ..db.pseudo import make_pseudo_db
from ..engine import SearchEngine, resolve_device


def parse_argv(argv):
    """(L, nseq, device) from ``[L] [nseq] [--device D]``."""
    argv = list(argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i : i + 2]
    if len(argv) > 2 or any(not a.isdigit() for a in argv):
        raise SystemExit(__doc__)
    L, nseq = [int(a) for a in argv] + [1024, 1_000_000][len(argv):]
    return L, nseq, resolve_device(device)


def run(L: int, nseq: int, device, query_lengths=QUERY_LENGTHS) -> dict:
    """Run the diagnostic and print its lines; returns {"set_database_s",
    "queries": [{"q", "gcups", "seconds"}], "total_gcups",
    "total_seconds"}."""
    queries = make_queries(query_lengths)
    engine = SearchEngine(num_top=0, device=device)
    t0 = time.perf_counter()
    engine.set_database(pseudo_to_dbdata(make_pseudo_db(nseq, L)))
    setup = time.perf_counter() - t0
    print(f"set_database: {setup:.1f}s", flush=True)
    engine.scan(queries[0])
    engine.scan(queries[-1])
    list(engine.scan_many(queries))  # every batch plan's first launches
    t0 = time.perf_counter()
    results = list(engine.scan_many(queries))
    total = time.perf_counter() - t0
    lines = []
    for qlen, res in zip(query_lengths, results):
        print(f"q={qlen:5d}: {res.stats.gcups:7.1f} GCUPS ({res.stats.seconds:6.2f}s)", flush=True)
        lines.append({"q": qlen, "gcups": res.stats.gcups, "seconds": res.stats.seconds})
    cells = float(sum(query_lengths)) * nseq * L
    print(f"TOTAL: {cells / 1e9 / total:.1f} GCUPS ({total:.1f}s)", flush=True)
    return {"set_database_s": setup, "queries": lines, "total_gcups": cells / 1e9 / total,
            "total_seconds": total}


def main(argv=None) -> int:
    L, nseq, device = parse_argv(sys.argv[1:] if argv is None else argv)
    run(L, nseq, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
