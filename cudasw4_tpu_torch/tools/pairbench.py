"""Experiment: P tiles per block for the cell kernel (the port's
counterpart of tools/pairbench.py).

``score_pair`` scores P consecutive cell tiles per block: each block owns
128 lanes of P tiles and each thread scores its P subjects one after
another (``sw_pair_kernel`` in csrc/sw_tools.cu, T / P x 32 blocks).  The
JAX kernel's ``unroll`` has no counterpart: the kernel's register block is
its 8 query rows.  Its plain version is the cell kernel's.

Usage: python -m cudasw4_tpu_torch.tools.pairbench [L] [num_subjects] [reps] [--device cpu]

For query lengths 32 and 512 it prints the cell kernel's (P=1) time and
real GCUPS, then P=2 and P=4 with OK or MISMATCH against the cell
kernel's scores (a P that does not divide the tile count is skipped).
Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import sys

from ..ops import cuda_lib, sw_cell
from .dmabench import bench_setup, parse_argv, timeit


def score_pair(tiles, query, matrix_flat, params, P: int = 2):
    """Scores f32 [T, 4096] of one query against cell tiles [T, L, 32, 128],
    P tiles per block, exact int32 state; T % P == 0.  ``query``, ``params``
    as ``sw_cell.score_bucket_cell``."""
    sw_cell._cell_tiles(tiles)
    if P < 1 or tiles.shape[0] % P:
        raise ValueError(f"{tiles.shape[0]} tiles do not split into groups of P={P}")
    if tiles.device.type == "cpu":
        cuda_lib.count(score_pair, True, plain=True)
        return sw_cell.score_bucket_cell_plain(tiles, query, matrix_flat, params)
    return cuda_lib.launch_tool(score_pair, "sw_pair_kernel", tiles, query, matrix_flat,
                                params, 0, P)


score_pair.launches = score_pair.launches16 = 0
score_pair.plain_calls = score_pair.plain_calls16 = 0


def main(argv=None) -> int:
    L, n, reps, device = parse_argv(sys.argv[1:] if argv is None else argv, __doc__)
    tiles, mat, params_for, queries = bench_setup(L, n, device, (32, 512))
    for qlen, q in queries:
        params = params_for(qlen)
        cells = float(qlen) * L * n
        base = timeit(lambda: sw_cell.score_bucket_cell(tiles, q, mat, params), reps, device)
        ref = sw_cell.score_bucket_cell(tiles, q, mat, params)
        print(f"q={qlen:5d} P=1: {base * 1e3:8.2f} ms {cells / 1e9 / base:8.2f} GCUPS")
        for P in (2, 4):
            if tiles.shape[0] % P:
                print(f"q={qlen:5d} P={P}: skipped, {tiles.shape[0]} tiles are not a multiple of P")
                continue
            dt = timeit(lambda: score_pair(tiles, q, mat, params, P=P), reps, device)
            got = score_pair(tiles, q, mat, params, P=P)
            ok = "OK" if bool((got == ref).all()) else "MISMATCH"
            print(f"q={qlen:5d} P={P}: {dt * 1e3:8.2f} ms {cells / 1e9 / dt:8.2f} GCUPS  [{ok}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
