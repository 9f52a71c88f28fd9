"""End-to-end search of a synthetic database with a Swiss-Prot-like length
distribution by the reference's 20-query set (the port's counterpart of
tools/dbbench.py).

Usage: python -m cudasw4_tpu_torch.tools.dbbench [num_seqs] [reps] [--device cpu]

The database is ``make_sprotlike_db(num_seqs)`` (tools/tremblbench.py:
log-normal(5.7, 0.55) lengths clipped to [20, 35000], median about 300,
seed 7; default 200,000 sequences; ``DBBENCH_CACHE=<dir>`` keeps the
arrays), resident on the device; the queries are random sequences of the
20 ``bench.QUERY_LENGTHS`` from ``np.random.default_rng(123)``, searched
by ``scan_many`` with ``num_top=10``.  One first pass (first launches and
the kernel build), then ``reps`` timed passes (default 2), each printed
with its milliseconds and GCUPS (query residues x database residues / 1e9
/ wall seconds), then the best and the peak device memory.  Runs on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import sys
import time

import torch

from ..bench import QUERY_LENGTHS, make_queries
from ..engine import SearchEngine, resolve_device
from .tremblbench import make_sprotlike_db


def parse_argv(argv):
    """(num_seqs, reps, device) from ``[num_seqs] [reps] [--device D]``."""
    argv = list(argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i : i + 2]
    if len(argv) > 2 or any(not a.isdigit() for a in argv):
        raise SystemExit(__doc__)
    n, reps = [int(a) for a in argv] + [200_000, 2][len(argv):]
    return n, reps, resolve_device(device)


def run(n: int, reps: int, device, query_lengths=QUERY_LENGTHS) -> dict:
    """The benchmark on ``n`` sequences, printing tools/dbbench.py's lines.
    Returns {"db", "queries", "results" (the last pass's ScanResults),
    "residues", "cells", "set_database_s", "first_pass_s", "passes"
    [(seconds, GCUPS)], "best_gcups", "peak_device_bytes" (None on the
    CPU)}."""
    cuda = device.type == "cuda"
    db = make_sprotlike_db(n)
    residues = float(db.lengths.sum())
    print(f"DB: {n} seqs, {residues / 1e6:.1f}M residues, max len {db.lengths.max()}")

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    engine = SearchEngine(num_top=10, verbose=True, device=device)
    t0 = time.perf_counter()
    engine.set_database(db)
    setup = time.perf_counter() - t0
    if engine.streaming:
        raise RuntimeError(f"the sprot-like database of {n} sequences streams")
    engine.print_db_length_partitions()

    queries = make_queries(query_lengths)
    cells = sum(query_lengths) * residues

    print("warmup/compile...")
    t0 = time.perf_counter()
    results = list(engine.scan_many(queries))
    first = time.perf_counter() - t0
    print(f"first pass (incl. compile): {first:.1f}s")
    passes = []
    for _ in range(reps):
        t0 = time.perf_counter()
        results = list(engine.scan_many(queries))
        dt = time.perf_counter() - t0
        passes.append((dt, cells / 1e9 / dt))
        print(f"pass: {dt * 1e3:.0f} ms  {passes[-1][1]:.2f} GCUPS")
    best = max((g for _, g in passes), default=0.0)
    print(f"BEST sprot-like total: {best:.2f} GCUPS")
    peak = None
    if cuda:
        peak = torch.cuda.max_memory_allocated(device)
        print(f"peak device memory {peak / 1e9:.3f} GB")
    return {"db": db, "queries": queries, "results": results, "residues": residues,
            "cells": cells, "set_database_s": setup, "first_pass_s": first, "passes": passes,
            "best_gcups": best, "peak_device_bytes": peak}


def main(argv=None) -> int:
    n, reps, device = parse_argv(sys.argv[1:] if argv is None else argv)
    run(n, reps, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
