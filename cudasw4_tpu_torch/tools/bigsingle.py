"""A/B: the cell kernel against the col kernel for long single queries on
cell-layout tiles (the port's counterpart of tools/bigsingle.py), the
measurement behind the engine's ``COL_SINGLE_MIN_ROWS`` routing.

Usage: python -m cudasw4_tpu_torch.tools.bigsingle [T] [reps] [--device cpu]

For each L in 256, 512 and 768 it scores T x 4096 random subjects of
exactly L residues (default T = 64; the tiles [T, L, 32, 128] serve both
kernels, since L is a multiple of LC) with single queries of 512, 1024,
2048, 3072 and 5478 residues, once through the cell kernel
(``sw_cell.score_bucket_cell``, B1) and once through the col kernel
(``sw_col.score_bucket_col_any_query``, B3, in NQC-row chunks with the H/F
carry past NQC), in exact int32 state and in int16 state, and prints one
line per (L, query, state): the JAX tool's line (each route's GCUPS and
the col route's change against the cell route), with OK when the two
routes agree (exact state: equal scores; int16 state: both routes' scores
meet the SAT rule, ``sw_cell.sat_match``, against the exact cell scores)
and MISMATCH otherwise.  Times are CUDA events, the best of ``reps``
calls (default 3) after one warm-up; the host clock on the CPU.  The
inputs are the JAX tool's, from ``np.random.default_rng(0)``.  Runs on
the card unless ``--device cpu`` is given (the plain versions: use small
sizes through ``run``).  Exits 1 if a line says MISMATCH.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..ops import cuda_lib, sw_cell, sw_col
from ..ops.sw_row import prepare_query
from ..substitution import make_scoring_config
from .colstate16 import parse_argv

#: The JAX tool's subject lengths and query lengths.
LENGTHS = (256, 512, 768)
QUERY_LENGTHS = (512, 1024, 2048, 3072, 5478)


def best_ms(fn, reps: int, device) -> float:
    """Best milliseconds of ``reps`` calls of ``fn`` after the caller's
    warm-up: CUDA events around each call on the card, the host clock on
    the CPU."""
    best = float("inf")
    for _ in range(reps):
        if device.type != "cuda":
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
            continue
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize(device)
        best = min(best, start.elapsed_time(stop))
    return best


def run(T: int, reps: int, device, lengths=LENGTHS, query_lengths=QUERY_LENGTHS) -> list[dict]:
    """Run the A/B and print its lines; returns one dict a line: L, q,
    state, each route's ms and GCUPS, the col/cell ratio and ok."""
    cfg = make_scoring_config("blosum62")
    rng = np.random.default_rng(0)
    mat = cuda_lib.device_matrix(cfg.matrix, device)
    ns = sw_cell.G * sw_cell.NSL
    n = T * ns
    lines = []
    for L in lengths:
        data = rng.integers(0, 20, size=(n, L)).astype(np.int8)
        x = data.reshape(T, ns, L).transpose(0, 2, 1).reshape(T, L, sw_cell.G, sw_cell.NSL)
        tiles = cuda_lib.to_device(np.ascontiguousarray(x), device)
        del data, x
        for qlen in query_lengths:
            codes = rng.integers(0, 20, size=qlen).astype(np.int8)
            qpad, nq = prepare_query(codes, qcap=max(sw_cell.QCAP, qlen), pad=cfg.pad_code)
            qd = cuda_lib.to_device(qpad, device)
            params = (nq, cfg.gop, cfg.gex, 0)
            cells = float(qlen) * L * n
            routes = {
                "cell": lambda exact: sw_cell.score_bucket_cell(tiles, qd, mat, params, exact=exact),
                "col": lambda exact: sw_col.score_bucket_col_any_query(
                    tiles, codes, mat, cfg.gop, cfg.gex, pad=cfg.pad_code, exact=exact),
            }
            want = None
            for exact in (True, False):
                scores, ms = {}, {}
                for route, call in routes.items():
                    scores[route] = call(exact)  # the warm-up
                    ms[route] = best_ms(lambda: call(exact), reps, device)
                if exact:
                    want = scores["cell"]
                    ok = bool(torch.equal(scores["col"], want))
                else:
                    ok = all(bool(sw_cell.sat_match(s, want).all()) for s in scores.values())
                gcups = {route: cells / 1e6 / t for route, t in ms.items()}
                ratio = gcups["col"] / gcups["cell"]
                state = "i32" if exact else "i16"
                print(f"L={L} q={qlen} {state}: cell {gcups['cell']:.1f} GCUPS, col "
                      f"{gcups['col']:.1f} GCUPS ({ratio - 1:+.1%}) [{'OK' if ok else 'MISMATCH'}]",
                      flush=True)
                lines.append({"L": L, "q": qlen, "state": state, "cell_ms": ms["cell"],
                              "col_ms": ms["col"], "cell_gcups": gcups["cell"],
                              "col_gcups": gcups["col"], "col_over_cell": ratio, "ok": ok})
    return lines


def main(argv=None) -> int:
    T, reps, device = parse_argv(sys.argv[1:] if argv is None else argv, __doc__)
    lines = run(T, reps, device)
    return 0 if all(line["ok"] for line in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
