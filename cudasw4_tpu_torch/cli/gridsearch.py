"""``gridsearch`` — kernel tuning sweep (the port's counterpart of
cudasw4_tpu/cli/gridsearch.py, with its flags, reduction and outputs).

    python -m cudasw4_tpu_torch.cli.gridsearch [--lengths 128,256,..]
        [--kernels row,cell,cellbatch,col] [--querylengths 512,..]
        [--chars N] [--reps R] [--nqcs n1,..] [--lcs c1,..]
        [--of sweep.tsv] [--emit-config tuning.json] [--device cuda|cpu]

Times the port's kernel wrappers (the row kernel, the cell kernel, the
cell batch kernel with 16 slots, the col kernel over NQC-row chunks) on
seeded pseudo databases of ``--chars`` residues per subject length, for
each query length, on the card with CUDA events (best of ``--reps`` after
one warm-up launch); on the CPU it times the plain versions, whose ratios
mean nothing for the card.  ``--nqcs``/``--lcs`` also sweep the col
kernels' (NQC, LC).  ``--of`` writes the sweep as TSV (kernel, length,
unroll, tiles, qlen, seconds, gcups); ``--emit-config`` writes the tuning
config that ``db.packing.apply_tuning`` and ``align --tuning`` read, its
``platform`` the CUDA device's name, so that a copy in
``cudasw4_tpu_torch/tuning/`` applies by default on that card.
``--unrolls`` is accepted as the JAX package's, but the port's kernels
have no unroll: it sweeps one value, ``sw_cell.DEFAULT_UNROLL``.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch


def derive_tuning(rows) -> dict:
    """Reduce sweep rows to a tuning config (the JAX package's
    ``derive_tuning``, line for line).

    ``rows``: (kernel, L, unroll, tiles, qlen, seconds, gcups) tuples.  For
    each (kernel, L, qlen) the best unroll is taken, but the default unroll
    keeps the key unless a candidate beats its rate by more than 2% (the
    noise band).  The speed ratios are the medians of best cell / best row
    (L <= CELL_MAX_L) and best col / best row (L > CELL_MAX_L) over the
    configurations where both ran; the unrolls are the mode of the winners
    per family (the batch kernel's rows decide the cell family when
    present); ``cell_max_l`` is the longest L where the cell kernel still
    beats the col kernel, emitted only when the sweep brackets the
    crossover.  Keys that could not be measured are left out, so that
    ``apply_tuning`` keeps its defaults.
    """
    from ..db.packing import CELL_MAX_L
    from ..ops import sw_cell, sw_col

    default_u = {
        "cell": sw_cell.DEFAULT_UNROLL,
        "cellbatch": sw_cell.DEFAULT_UNROLL,
        "col": sw_col.DEFAULT_UNROLL,
    }
    by_key: dict = {}  # (kernel, L, qlen) -> {unroll: gcups}
    for kernel, L, U, _T, nq, _dt, gcups in rows:
        d = by_key.setdefault((kernel, L, nq), {})
        d[U] = max(d.get(U, 0.0), gcups)
    best: dict = {}  # (kernel, L, qlen) -> gcups of the winning unroll
    unrolls: dict = {}
    for key, d in by_key.items():
        du = default_u.get(key[0])
        top_u = max(d, key=lambda u: d[u])
        if du in d and d[top_u] <= d[du] * 1.02:
            top_u = du
        best[key] = d[top_u]
        unrolls[key] = top_u
    ratios = {"cell": [], "col": []}
    for (kernel, L, nq), g in best.items():
        if kernel == "row":
            continue
        row_g = best.get(("row", L, nq))
        if not row_g:
            continue
        if kernel == "cell" and L <= CELL_MAX_L:
            ratios["cell"].append(g / row_g)
        elif kernel == "col" and L > CELL_MAX_L:
            ratios["col"].append(g / row_g)
    cfg: dict = {"version": 1}
    if ratios["cell"]:
        cfg["cell_speedup"] = round(float(np.median(ratios["cell"])), 3)
    if ratios["col"]:
        cfg["col_speedup"] = round(float(np.median(ratios["col"])), 3)
    for fam, key in (("cell", "cell_unroll"), ("col", "col_unroll")):
        fams = (fam,)
        if fam == "cell" and any(k[0] == "cellbatch" for k in best):
            fams = ("cellbatch",)
        us = [unrolls[k] for k in best if k[0] in fams]
        if us:
            vals, counts = np.unique(us, return_counts=True)
            cfg[key] = int(vals[np.argmax(counts)])
    cell_wins, col_wins = [], []
    for (kernel, L, nq), g in best.items():
        other = best.get((("col" if kernel == "cell" else "cell"), L, nq))
        if other is None:
            continue
        if kernel == "cell" and g >= other:
            cell_wins.append(L)
        elif kernel == "col" and g > other:
            col_wins.append(L)
    if cell_wins and col_wins and max(cell_wins) < min(col_wins):
        cfg["cell_max_l"] = int(max(cell_wins))
    cfg["best"] = [
        {"kernel": k, "length": L, "qlen": nq, "unroll": unrolls[(k, L, nq)],
         "gcups": round(g, 1)}
        for (k, L, nq), g in sorted(best.items())
    ]
    return cfg


def select_col_geometry(rows, incumbent):
    """Pick (NQC, LC) from sweep rows [(nqc, lc, L, gcups), ...] (the JAX
    package's ``select_col_geometry``): the best row must beat the
    incumbent's measured rate by more than 2% to replace it; an unmeasured
    incumbent takes the plain best."""
    if not rows:
        return incumbent
    inc = [g for nqc, lc, _L, g in rows if (nqc, lc) == tuple(incumbent)]
    top = max(rows, key=lambda r: r[3])
    if inc and top[3] <= max(inc) * 1.02:
        return tuple(incumbent)
    return top[0], top[1]


def _best_seconds(fn, reps: int, device: torch.device) -> float:
    """Best seconds of ``reps`` calls of ``fn`` after one warm-up call:
    CUDA events on the card, the wall clock on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return min(times)


def _wide_tiles(data, device):
    """Cell-layout tiles [n / 4096, L, 32, 128] of subjects ``data`` [n, L]."""
    n, L = data.shape
    tiles = data.reshape(n // 4096, 4096, L).transpose(0, 2, 1).reshape(n // 4096, L, 32, 128)
    return torch.as_tensor(np.ascontiguousarray(tiles)).to(device)


def sweep_col_geometry(nqcs, lcs, num_chars, reps, device):
    """Time the col kernel over (NQC, LC) pairs on ``device`` through
    ``sw_col.score_bucket_col_any_query`` with a query of NQC residues;
    returns (best_nqc, best_lc, rows), rows (nqc, lc, L, gcups), the best
    by ``select_col_geometry`` against the current values, which are
    restored afterwards."""
    from .. import make_scoring_config
    from ..ops import cuda_lib, sw_col

    cfg = make_scoring_config("blosum62")
    mat = cuda_lib.device_matrix(cfg.matrix, device)
    rng = np.random.default_rng(42)
    save = (sw_col.NQC, sw_col.LC)
    rows = []
    try:
        for lc in lcs:
            L = max(lc, 2048 // lc * lc)
            n = max(4096, num_chars // (L * 4096) * 4096)
            tiles = _wide_tiles(rng.integers(0, 20, size=(n, L)).astype(np.int8), device)
            for nqc in nqcs:
                sw_col.NQC, sw_col.LC = nqc, lc
                q = rng.integers(0, 20, size=nqc).astype(np.int8)
                dt = _best_seconds(lambda: sw_col.score_bucket_col_any_query(
                    tiles, q, mat, cfg.gop, cfg.gex), reps, device)
                g = float(nqc) * L * n / dt / 1e9
                rows.append((nqc, lc, L, g))
                print(f"   col NQC={nqc} LC={lc} L={L}: {g:.1f} GCUPS")
    finally:
        sw_col.NQC, sw_col.LC = save
    nqc, lc = select_col_geometry(rows, save)
    return nqc, lc, rows


USAGE = ("Usage: gridsearch [--lengths l1,l2,..] [--kernels row,cell,cellbatch,col]"
         " [--unrolls u1,..] [--querylengths q1,..] [--chars N] [--nqcs n1,..]"
         " [--lcs c1,..] [--reps R] [--of file] [--emit-config tuning.json]"
         " [--device cuda|cpu]")


def run(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    lengths = [128, 256, 512, 1024, 2048]
    kernels = ["row", "cell", "cellbatch", "col"]
    unrolls = [2, 4, 8]
    qlens = [512]
    num_chars = 32 << 20  # residues a pseudo database (fixed work a config)
    reps = 3
    outfile = emit_config = device = None
    nqcs, lcs = [], []
    i = 0
    while i < len(argv):
        a = argv[i]

        def val():
            nonlocal i
            i += 1
            return argv[i]

        if a == "--lengths":
            lengths = [int(x) for x in val().split(",")]
        elif a == "--kernels":
            kernels = val().split(",")
        elif a == "--unrolls":
            unrolls = [int(x) for x in val().split(",")]
        elif a == "--querylengths":
            qlens = [int(x) for x in val().split(",")]
        elif a == "--nqcs":
            nqcs = [int(x) for x in val().split(",")]
        elif a == "--lcs":
            lcs = [int(x) for x in val().split(",")]
        elif a == "--chars":
            num_chars = int(val())
        elif a == "--reps":
            reps = int(val())
        elif a == "--of":
            outfile = val()
        elif a == "--emit-config":
            emit_config = val()
        elif a == "--device":
            device = val()
        elif a == "--help":
            print(USAGE)
            print("--emit-config writes a tuning JSON for CUDASW4_TPU_TORCH_TUNING / align"
                  " --tuning (or, named for the card, cudasw4_tpu_torch/tuning/): kernel"
                  " speed ratios and the cell/col crossover length feed the bucket layout"
                  " chooser; --nqcs/--lcs also sweep the col kernels' query rows a call"
                  " and length granule (col_nqc / col_lc).")
            return 0
        else:
            print(f"Unexpected arg {a}")
        i += 1

    from .. import make_scoring_config
    from ..engine import resolve_device
    from ..ops import cuda_lib, sw_cell, sw_col, sw_row
    from ..ops.sw_row import prepare_query

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    U = sw_cell.DEFAULT_UNROLL
    if unrolls != [U]:
        print(f"(--unrolls {','.join(map(str, unrolls))}: the port's kernels have no unroll; "
              f"sweeping {U}, the row granule)")
    cfg = make_scoring_config("blosum62")
    mat = cuda_lib.device_matrix(cfg.matrix, dev)
    rng = np.random.default_rng(42)
    rows = []
    print(f"{'kernel':>6} {'length':>7} {'unroll':>6} {'tiles':>6} {'qlen':>5}"
          f" {'ms':>9} {'GCUPS':>9}")
    best: dict = {}
    for L in lengths:
        n = max(4096, num_chars // (L * 4096) * 4096)
        data = rng.integers(0, 20, size=(n, L)).astype(np.int8)
        Tc, Tr = n // 4096, n // 128
        tiles_wide = _wide_tiles(data, dev)
        tiles_row = torch.as_tensor(
            np.ascontiguousarray(data.reshape(Tr, 128, L).transpose(0, 2, 1))).to(dev)
        for qlen in qlens:
            q = rng.integers(0, 20, size=min(qlen, sw_cell.QCAP)).astype(np.int8)
            qpad, nq = prepare_query(q)
            qdev = torch.as_tensor(qpad).to(dev)
            cells = float(n) * L * nq
            params = (nq, cfg.gop, cfg.gex, sw_col.padded_rows(nq))
            # A 16-slot batch of the query: the engine's cell path for
            # batched scans.
            QB = 16
            qb = np.full((QB, max(256, nq)), cfg.pad_code, np.int32)
            qb[:, :nq] = q
            qb_dev = torch.as_tensor(qb).to(dev)
            pb = (0, cfg.gop, cfg.gex, 0, *([nq] * QB))
            for kernel in kernels:
                cells_k = cells
                if kernel == "row":
                    def once():
                        return sw_row.score_bucket_row(tiles_row, qdev, mat, params)
                elif kernel == "cell":
                    def once():
                        return sw_cell.score_bucket_cell(tiles_wide, qdev, mat, params)
                elif kernel == "cellbatch":
                    from ..db.packing import CELL_MAX_L

                    if L > CELL_MAX_L or L % U:
                        continue
                    cells_k = cells * QB

                    def once():
                        return sw_cell.score_bucket_cell_batch(tiles_wide, qb_dev, mat, pb)
                elif kernel == "col":
                    if L % sw_col.LC:
                        continue

                    def once():
                        return sw_col.score_bucket_col_any_query(tiles_wide, q, mat, cfg.gop,
                                                                 cfg.gex)
                else:
                    print(f"unknown kernel {kernel}")
                    continue
                dt = _best_seconds(once, reps, dev)
                gcups = cells_k / dt / 1e9
                T = Tr if kernel == "row" else Tc
                print(f"{kernel:>6} {L:>7} {U:>6} {T:>6} {nq:>5} {dt * 1e3:>9.2f} {gcups:>9.1f}")
                rows.append((kernel, L, U, T, nq, dt, gcups))
                if (L, nq) not in best or gcups > best[(L, nq)][2]:
                    best[(L, nq)] = (kernel, U, gcups)

    print("\nBest kernel per (length, querylength):")
    for (L, nq), (kernel, u, gcups) in sorted(best.items()):
        print(f"  L={L:5d} q={nq:5d}: {kernel} unroll={u} ({gcups:.1f} GCUPS)")
    geo = None
    if nqcs or lcs:
        print("\nColumn-kernel geometry sweep (NQC x LC):")
        geo = sweep_col_geometry(nqcs or [sw_col.NQC], lcs or [sw_col.LC], num_chars, reps, dev)
        print(f"  best: NQC={geo[0]} LC={geo[1]}")
    if outfile:
        with open(outfile, "w") as f:
            f.write("kernel\tlength\tunroll\ttiles\tqlen\tseconds\tgcups\n")
            for r in rows:
                f.write("\t".join(str(x) for x in r) + "\n")
    if emit_config:
        tuning = derive_tuning(rows)
        if geo is not None:
            tuning["col_nqc"], tuning["col_lc"] = int(geo[0]), int(geo[1])
        tuning["platform"] = torch.cuda.get_device_name(dev) if on_card else "cpu"
        with open(emit_config, "w") as f:
            json.dump(tuning, f, indent=1)
        print(f"\nTuning config written to {emit_config}")
        if not on_card:
            print("(CPU sweep: speed ratios are not meaningful — "
                  "run on the card before applying)")
    return 0


def main():
    raise SystemExit(run())


if __name__ == "__main__":
    main()
