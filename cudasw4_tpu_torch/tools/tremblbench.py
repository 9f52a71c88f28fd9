"""TrEMBL-scale streamed rehearsal (the port's counterpart of
tools/tremblbench.py): a synthetic database of TrEMBL's scale class,
larger than the device budget, streamed from the disk-backed tile store
against the 14-query mixed batch.

Usage:
  DBBENCH_CACHE=dir TREMBL_STORE=path \\
  python -m cudasw4_tpu_torch.tools.tremblbench [reps] [--scale F] [--device cpu]

The database is N = 20,000,000 / F sequences of the sprot-like length
model (``make_sprotlike_db``: log-normal(5.7, 0.55) clipped to [20,
35000], residues uniform over the 20 amino acids, seed 7; about 6.94G
residues at F = 1), cached as an npz under ``DBBENCH_CACHE`` when it is
set.  The device budget is ``TREMBL_BUDGET`` (default 4 GiB) / F, and the
streamed chunk STREAM_CHUNK_BYTES, or STREAM_CHUNK_BYTES / F where a
pass's working memory (``engine_streaming.stream_work_bytes``) at the
full chunk would pass the budget; the database must stream.  The tile
store goes to ``TREMBL_STORE`` (default build/tremblbench/store beside
the package).  The 14 queries (144-3000 aa, 13,785 residues, from
``np.random.default_rng(123)``) run through ``scan_batch``: a first pass,
then ``reps`` passes (default 2), each printed with its seconds and
GCUPS; then the copy stream's chunks, bytes and GB/s over the last pass
(``stream_copy_stats``) and the peak device memory against the budget.
Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import engine_streaming
from ..db.format import DBData
from ..db.packing import planned_shapes
from ..engine import SearchEngine, resolve_device

#: TrEMBL's scale class at F = 1: sequences, and the device budget that
#: forces the streamed configuration (the database would fit an H100).
N = 20_000_000
BUDGET = int(os.environ.get("TREMBL_BUDGET", str(4 << 30)))
STORE = os.environ.get(
    "TREMBL_STORE", str(Path(__file__).resolve().parents[2] / "build" / "tremblbench" / "store"))

#: The 14-query mixed batch (the JAX tool's).
QUERY_LENGTHS = (144, 192, 256, 306, 370, 492, 564, 657, 780, 1024, 1500, 2000, 2500, 3000)

#: Residues drawn per call of the generator: the draws of consecutive
#: calls are those of one call, so the database does not depend on it.
GEN_CHUNK = 1 << 26


def make_sprotlike_db(n: int, seed: int = 7) -> DBData:
    """The sprot-like synthetic database of tools/dbbench.py (the port's
    own copy; the same draws, so the same database): ``n`` lengths from
    log-normal(5.7, 0.55) clipped to [20, 35000], sorted, residues uniform
    over codes 0..19, headers "s<i>".  Set ``DBBENCH_CACHE=<dir>`` to save
    the arrays there and load them on later runs."""
    cache = os.environ.get("DBBENCH_CACHE")
    path = cache and os.path.join(cache, f"sprotlike_{n}_{seed}.npz")
    if path and os.path.exists(path):
        z = np.load(path)
        return DBData(chars=z["chars"], offsets=z["offsets"], lengths=z["lengths"],
                      headers=z["headers"], header_offsets=z["hoffs"])
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.lognormal(mean=5.7, sigma=0.55, size=n), 20, 35000).astype(np.int32)
    lengths.sort()
    padded = (lengths + 3) // 4 * 4
    offsets = np.concatenate([[0], np.cumsum(padded, dtype=np.int64)]).astype(np.uint64)
    chars = np.empty(int(offsets[-1]), np.int8)
    for s in range(0, chars.size, GEN_CHUNK):
        k = min(GEN_CHUNK, chars.size - s)
        chars[s : s + k] = rng.integers(0, 20, size=k)
    names = [f"s{i}\n".encode() for i in range(n)]
    hoffs = np.zeros(n + 1, np.uint64)
    np.cumsum([len(h) for h in names], out=hoffs[1:])
    db = DBData(chars=chars, offsets=offsets, lengths=lengths,
                headers=np.frombuffer(b"".join(names), np.uint8), header_offsets=hoffs)
    if path:
        os.makedirs(cache, exist_ok=True)
        np.savez(path, chars=chars, offsets=offsets, lengths=lengths, headers=db.headers,
                 hoffs=hoffs)
    return db


def chunk_for(lengths, budget: int, scale: float) -> int:
    """The streamed chunk's byte cap: STREAM_CHUNK_BYTES, divided by
    ``scale`` where a pass's working memory at the full chunk passes the
    budget."""
    chunk = engine_streaming.STREAM_CHUNK_BYTES
    work, _ = engine_streaming.stream_work_bytes(planned_shapes(lengths), chunk, None,
                                                 SearchEngine.QB_STREAM)
    return chunk if work <= budget else int(chunk / scale)


def parse_argv(argv):
    """(reps, scale, device) from ``[reps] [--scale F] [--device D]``."""
    argv = list(argv)
    opts = {"--scale": "1", "--device": None}
    for name in opts:
        if name in argv:
            i = argv.index(name)
            opts[name] = argv[i + 1]
            del argv[i : i + 2]
    if len(argv) > 1 or any(not a.isdigit() for a in argv):
        raise SystemExit(__doc__)
    scale = float(opts["--scale"])
    if scale <= 0:
        raise SystemExit(f"--scale must be positive, got {scale}")
    return (int(argv[0]) if argv else 2), scale, resolve_device(opts["--device"])


def run(n: int, reps: int, budget: int, store: str, device, scale: float = 1.0,
        chunk_bytes: int | None = None, query_lengths=QUERY_LENGTHS) -> dict:
    """The rehearsal on ``n`` sequences under ``budget``, printing its
    lines; streamed chunks of ``chunk_bytes`` (default ``chunk_for`` at
    ``scale``).  Returns {"db", "chunk_bytes",
    "queries", "results" (the last pass's ScanResults), "residues",
    "work_bytes", "set_database_s", "first_pass_s", "passes" [(seconds,
    GCUPS)], "best_gcups", "copy" (``stream_copy_stats`` with "gb_per_s"),
    "peak_device_bytes" (None on the CPU)}."""
    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    db = make_sprotlike_db(n)
    residues = float(db.lengths.sum())
    print(f"DB: {n} seqs, {residues / 1e9:.2f}G residues (gen/load "
          f"{time.perf_counter() - t0:.0f}s)", flush=True)
    if chunk_bytes is None:
        chunk_bytes = chunk_for(db.lengths, budget, scale)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    engine = SearchEngine(num_top=10, verbose=True, max_device_bytes=budget,
                          stream_chunk_bytes=chunk_bytes, device=device)
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(store) or ".", exist_ok=True)
    engine.set_database(db, pack_cache=store)
    setup = time.perf_counter() - t0
    print(f"set_database: {setup:.0f}s", flush=True)
    if not engine.streaming:
        raise RuntimeError("the TrEMBL-scale database must stream")
    work = engine._work_bytes
    print(f"budget {budget / 1e9:.3f} GB, chunk {chunk_bytes / 2**20:.1f} MiB, a pass's working "
          f"memory {work / 1e9:.3f} GB", flush=True)

    rng = np.random.default_rng(123)
    queries = [rng.integers(0, 20, q).astype(np.int8) for q in query_lengths]
    cells = sum(query_lengths) * residues
    print("first pass (incl. first launches)...", flush=True)
    t0 = time.perf_counter()
    results = engine.scan_batch(queries)
    first = time.perf_counter() - t0
    print(f"first pass: {first:.0f}s", flush=True)
    passes = []
    for _ in range(reps):
        t0 = time.perf_counter()
        results = engine.scan_batch(queries)
        dt = time.perf_counter() - t0
        passes.append((dt, cells / 1e9 / dt))
        print(f"pass: {dt:.0f}s  {passes[-1][1]:.2f} GCUPS", flush=True)
    best = max((g for _, g in passes), default=0.0)
    print(f"BEST trembl rehearsal: {best:.2f} GCUPS")
    copy = engine.stream_copy_stats()
    copy["gb_per_s"] = copy["bytes"] / copy["copy_ms"] / 1e6 if copy["copy_ms"] else None
    print(f"copy stream: {copy['chunks']} chunks, {copy['bytes'] / 1e9:.3f} GB"
          + (f", {copy['gb_per_s']:.1f} GB/s" if copy["gb_per_s"] else ""), flush=True)
    peak = None
    if cuda:
        peak = torch.cuda.max_memory_allocated(device) - base
        print(f"peak device memory {peak / 1e9:.3f} GB against the budget "
              f"{budget / 1e9:.3f} GB", flush=True)
    return {"db": db, "chunk_bytes": chunk_bytes, "queries": queries, "results": results, "residues": residues,
            "work_bytes": work, "set_database_s": setup, "first_pass_s": first,
            "passes": passes, "best_gcups": best, "copy": copy, "peak_device_bytes": peak}


def main(argv=None) -> int:
    reps, scale, device = parse_argv(sys.argv[1:] if argv is None else argv)
    run(int(N / scale), reps, int(BUDGET / scale), STORE, device, scale)
    return 0


if __name__ == "__main__":
    sys.exit(main())
