"""Benchmark entry point of the port: the counterpart of the repository's
root ``bench.py`` (its peak protocol, its knobs, its one JSON line).

Usage: python -m cudasw4_tpu_torch.bench [--device cpu]

Environment, with bench.py's defaults:
  BENCH_MODE          sweep (default) or peak
  BENCH_NUM_SEQS      1,000,000 in sweep mode, 500,000 in peak mode
  BENCH_SEQ_LEN       256 (peak mode only)
  BENCH_REPS          2
  BENCH_INIT_TIMEOUT  600 (seconds for the device's initialisation)

The protocol is the reference's peak benchmark (runpeakbenchmark.sh):
pseudo databases of ``BENCH_NUM_SEQS`` identical sequences, one per L in
{128, 256, 512, 768, 1024, 2048} in sweep mode (one of ``BENCH_SEQ_LEN``
in peak mode), each scanned by random queries of the reference set's 20
lengths (144..5478 aa, from ``np.random.default_rng(123)``) with
``num_top=0``: two warm scans, then the best of ``BENCH_REPS`` timed
passes of ``scan_many``.  Sweep mode reports the aggregate GCUPS (total
cells over total best seconds).

Standard output carries exactly one line,
  {"metric": "peak_sweep_total_gcups_single_chip" (sweep) or
   "peak_total_gcups_single_chip" (peak), "value": GCUPS, "unit": "GCUPS",
   "vs_baseline": value / 1000}
and everything else goes to standard error: one ``# L=...`` line a
configuration, each timed pass, each configuration's device bytes and peak
device memory, and the kernels' launch counters over the run.  Without a
CUDA device the line has ``"value": 0.0`` and an ``"error"``, and the exit
code is 2; a device initialisation past ``BENCH_INIT_TIMEOUT`` exits 3,
any other failure 1.  Only ``--device cpu`` runs the plain PyTorch
versions on the CPU.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import sys
import threading
import traceback

import numpy as np
import torch

from .db.format import pseudo_to_dbdata
from .db.pseudo import make_pseudo_db
from .engine import SearchEngine
from .ops import sw_cell, sw_col, sw_row

#: The nominal single-GPU peak that ``vs_baseline`` divides by (bench.py's).
NOMINAL_GPU_PEAK_GCUPS = 1000.0

#: The lengths of the reference's 20 benchmark queries (allqueries.fasta;
#: benchmarks/make_queries.py holds the same list).
QUERY_LENGTHS = (
    144, 189, 222, 375, 464, 567, 657, 729, 850, 1000,
    1500, 2005, 2504, 3005, 3564, 4061, 4548, 4743, 5147, 5478,
)

#: The sweep's subject lengths (runpeakbenchmark.sh's pseudo lengths).
SWEEP_LENGTHS = (128, 256, 512, 768, 1024, 2048)

AAS = "ARNDCQEGHILKMFPSTWYV"


def make_queries(lengths=QUERY_LENGTHS) -> list[str]:
    """Random protein queries of ``lengths`` from ``default_rng(123)`` (the
    JAX bench.py's and tools' queries)."""
    rng = np.random.default_rng(123)
    return ["".join(AAS[c] for c in rng.integers(0, 20, n)) for n in lengths]


def metric_name(mode: str) -> str:
    return "peak_sweep_total_gcups_single_chip" if mode == "sweep" else "peak_total_gcups_single_chip"


def result_line(metric: str, value: float, error: str | None = None) -> str:
    """The one JSON line of bench.py's contract (``error`` added on a failure)."""
    out = {"metric": metric, "value": round(value, 2), "unit": "GCUPS",
           "vs_baseline": round(value / NOMINAL_GPU_PEAK_GCUPS, 4)}
    if error is not None:
        out["error"] = error
    return json.dumps(out)


def launch_counts() -> dict:
    """The engine kernels' counters so far in this process, by wrapper and
    state mode (chip_smoke.py's names): {name: [launches, plain calls]}."""
    wrappers = {"cell": sw_cell.score_bucket_cell, "row": sw_row.score_bucket_row,
                "col": sw_col.score_bucket_col, "cell_batch": sw_cell.score_bucket_cell_batch,
                "col_flat": sw_col.score_bucket_col_flat,
                "col_fused": sw_col.score_bucket_col_flat_fused}
    return {name + mode: [getattr(fn, "launches" + mode, 0), getattr(fn, "plain_calls" + mode, 0)]
            for name, fn in wrappers.items() for mode in ("", "16")}


def touch_device(device) -> None:
    """Initialise CUDA and place one tensor on ``device``."""
    torch.cuda.init()
    torch.zeros(1, device=device)
    torch.cuda.synchronize(device)


def init_device_watchdog(device, metric: str, timeout_s: float) -> None:
    """``touch_device`` under a hang guard: past ``timeout_s`` print the
    contract line with an error and exit 3 instead of hanging the caller
    (bench.py's watchdog).  Kernel builds come after, outside the timer."""
    done = threading.Event()

    def watch():
        if not done.wait(timeout_s):
            print(result_line(metric, 0.0, f"device init exceeded {timeout_s:g}s"), flush=True)
            os._exit(3)

    threading.Thread(target=watch, daemon=True).start()
    touch_device(device)
    done.set()


@contextlib.contextmanager
def stdout_to_stderr():
    """Send standard output, Python's and the file descriptor's (child
    processes, native code), to standard error."""
    sys.stdout.flush()
    saved = os.dup(1)
    os.dup2(2, 1)
    try:
        with contextlib.redirect_stdout(sys.stderr):
            yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


def run_config(num: int, length: int, queries, reps: int, device):
    """Best total GCUPS for one pseudo-database configuration, warmed
    (bench.py's ``_run_config``): returns (best GCUPS, its seconds, the
    cells of one pass).  Each timed pass, the device bytes of the tiles and
    the peak device memory go to standard error.  Raises if the database
    streams: the protocol measures a resident database."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    engine = SearchEngine(num_top=0, device=device)
    engine.set_database(pseudo_to_dbdata(make_pseudo_db(num, length)))
    if engine.streaming:
        raise RuntimeError(f"the pseudo database of {num} x {length} streams; the protocol "
                           "measures a resident one")
    engine.scan(queries[0])  # kernel build and first launches
    engine.scan(queries[-1])
    best, best_secs = 0.0, None
    for rep in range(reps):
        engine.total_timer_start()
        for _res in engine.scan_many(queries):
            pass
        total = engine.total_timer_stop()
        print(f"# rep {rep + 1} at {length}: {total.seconds:.3f}s {total.gcups:.2f} GCUPS",
              file=sys.stderr, flush=True)
        if total.gcups > best:
            best, best_secs = total.gcups, total.seconds
    # total_timer_start resets the cell counter, so after the loop it
    # holds exactly one protocol pass worth of cells.
    cells = engine._total_cells
    tile_bytes = sum(t.numel() * t.element_size() for t in engine._bucket_tiles)
    peak = f"{torch.cuda.max_memory_allocated(device)} B" if cuda else "not measured"
    print(f"# resident {num} x {length}: tiles {tile_bytes} B, peak device memory {peak}",
          file=sys.stderr, flush=True)
    # One database on the device at a time: free this one before the next.
    del engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return best, best_secs, cells


def parse_argv(argv):
    """The device from ``[--device D]`` (None: CUDA)."""
    argv = list(argv)
    if argv[:1] == ["--device"] and len(argv) == 2:
        return argv[1]
    if argv:
        raise SystemExit(__doc__)
    return None


def main(argv=None) -> int:
    device = parse_argv(sys.argv[1:] if argv is None else argv)
    mode = os.environ.get("BENCH_MODE", "sweep")
    metric = metric_name(mode)
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print(result_line(metric, 0.0, "no CUDA device: torch.cuda.is_available() is "
                              "false (--device cpu runs the plain versions)"), flush=True)
            return 2
        init_device_watchdog(device, metric, float(os.environ.get("BENCH_INIT_TIMEOUT", 600)))
    reps = int(os.environ.get("BENCH_REPS", 2))
    queries = make_queries()
    try:
        with stdout_to_stderr():
            if mode == "sweep":
                num = int(os.environ.get("BENCH_NUM_SEQS", 1_000_000))
                total_cells = total_secs = 0.0
                for length in SWEEP_LENGTHS:
                    gcups, secs, cells = run_config(num, length, queries, reps, device)
                    total_cells += cells
                    total_secs += secs
                    print(f"# L={length}: {gcups:.2f} GCUPS ({secs:.1f}s)", file=sys.stderr)
                best = total_cells / 1e9 / total_secs
            else:
                num = int(os.environ.get("BENCH_NUM_SEQS", 500_000))
                length = int(os.environ.get("BENCH_SEQ_LEN", 256))
                best, _, _ = run_config(num, length, queries, reps, device)
            print("# launches: " + json.dumps(launch_counts()), file=sys.stderr, flush=True)
    except Exception as ex:  # the caller reads one line, whatever happened
        traceback.print_exc()
        print(result_line(metric, 0.0, f"{type(ex).__name__}: {ex}"), flush=True)
        return 1
    print(result_line(metric, best), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
