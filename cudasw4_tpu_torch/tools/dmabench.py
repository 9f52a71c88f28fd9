"""A/B bench: the cell kernel against its manual-staging twin (the port's
counterpart of tools/dmabench.py).

Usage: python -m cudasw4_tpu_torch.tools.dmabench [L] [num_subjects] [reps] [--device cpu]

For query lengths 32, 128 and 512 against num_subjects random subjects of
length L (default 512 and 262144) it prints the cell kernel's ("auto")
time and real GCUPS, then the manual-staging kernel's with OK or MISMATCH
against the cell kernel's scores.  The JAX tool's second manual line (DMA
priority 1) has no counterpart: Hopper's copies have no queue priority,
so there is one "manual" line.  Times are the best of ``reps`` calls after
one warm-up, synchronised on the card.  Runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..ops import cuda_lib, sw_cell
from ..ops.sw_row import prepare_query
from ..substitution import make_scoring_config


def parse_argv(argv, doc):
    """(L, num_subjects, reps, device) from ``[L] [n] [reps] [--device D]``."""
    argv = list(argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i : i + 2]
    if len(argv) > 3 or any(not a.isdigit() for a in argv):
        raise SystemExit(doc)
    L, n, reps = [int(a) for a in argv] + [512, 262144, 3][len(argv):]
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run the plain versions")
    return L, n, reps, dev


def bench_setup(L: int, n: int, device, qlens):
    """The JAX tool's inputs from seed 0: tiles [n / 4096, L, 32, 128] of
    random residues, the blosum62 matrix, a params maker and the padded
    query of each length in ``qlens``."""
    cfg = make_scoring_config("blosum62")
    rng = np.random.default_rng(0)
    T = n // (sw_cell.G * sw_cell.NSL)
    data = rng.integers(0, 20, size=(n, L)).astype(np.int8)
    x = data.reshape(T, sw_cell.G * sw_cell.NSL, L).transpose(0, 2, 1).reshape(T, L, 32, 128)
    tiles = cuda_lib.to_device(np.ascontiguousarray(x), device)
    mat = cuda_lib.device_matrix(cfg.matrix, device)
    queries = []
    for qlen in qlens:
        qpad, _ = prepare_query(rng.integers(0, 20, size=qlen))
        queries.append((qlen, cuda_lib.to_device(qpad, device)))

    def params_for(qlen):
        return (qlen, cfg.gop, cfg.gex, 0)

    return tiles, mat, params_for, queries


def timeit(fn, reps: int, device) -> float:
    """Best seconds of ``reps`` calls of ``fn`` after one warm-up, each
    synchronised on the card."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None) -> int:
    L, n, reps, device = parse_argv(sys.argv[1:] if argv is None else argv, __doc__)
    tiles, mat, params_for, queries = bench_setup(L, n, device, (32, 128, 512))
    for qlen, q in queries:
        params = params_for(qlen)
        cells = float(qlen) * L * n
        auto = timeit(lambda: sw_cell.score_bucket_cell(tiles, q, mat, params), reps, device)
        ref = sw_cell.score_bucket_cell(tiles, q, mat, params)
        print(f"q={qlen:5d} auto    : {auto * 1e3:8.2f} ms {cells / 1e9 / auto:8.2f} GCUPS")
        man = timeit(lambda: sw_cell.score_bucket_cell_manual(tiles, q, mat, params), reps, device)
        got = sw_cell.score_bucket_cell_manual(tiles, q, mat, params)
        ok = "OK" if bool((got == ref).all()) else "MISMATCH"
        print(f"q={qlen:5d} manual  : {man * 1e3:8.2f} ms {cells / 1e9 / man:8.2f} GCUPS  [{ok}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
