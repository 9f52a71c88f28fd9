"""A/B of the col kernels' DP state: int32 against int16 (the port's
counterpart of tools/colstate16.py), at the peak-sweep col configs
(L = 1024 and 2048).

Usage: python -m cudasw4_tpu_torch.tools.colstate16 [T] [reps] [--device cpu]

For each L it scores T x 4096 random subjects of L residues (default T =
64) with single queries of 1024 and 2048 rows through the col kernel
(``sw_col.score_bucket_col``, B3), then with flat passes of 2 x 1024,
3 x 1024 and 6 x 512 rows through the col flat kernel
(``sw_col.score_bucket_col_flat``, B5, each slot at its own FLAT_QUANT
offset of a pool of NQC rows), each in int32 and in int16 state, and
prints one line per call: the JAX tool's ``single ...`` and ``flat ...``
lines (GCUPS of each mode and the int16 mode's change), then the largest
absolute difference between the two modes' scores where the SAT rule
(``sw_cell.sat_match``) asks them to be equal, with OK or MISMATCH.
Times are CUDA events, the mean of ``reps`` calls (default 3) after one
warm-up (the JAX tool's best-of-wall-clock does not carry over).  The
inputs are the JAX tool's, from ``np.random.default_rng(0)``.  Runs on the
card unless ``--device cpu`` is given (the plain versions: use a small
T).  Exits 1 if a line says MISMATCH.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..ops import cuda_lib, sw_cell, sw_col
from ..substitution import make_scoring_config

#: The JAX tool's subject lengths, single queries and flat passes.
LENGTHS = (1024, 2048)
QUERY_LENGTHS = (1024, 2048)
SLOT_SETS = ((1024, 1024), (1024, 1024, 1024), (512,) * 6)


def parse_argv(argv, doc=__doc__):
    """(T, reps, device) from ``[T] [reps] [--device D]``; a malformed
    command line exits with the usage ``doc``."""
    argv = list(argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i : i + 2]
    if len(argv) > 2 or any(not a.isdigit() for a in argv):
        raise SystemExit(doc)
    T, reps = [int(a) for a in argv] + [64, 3][len(argv):]
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run the plain versions")
    return T, reps, dev


def mean_ms(fn, reps: int, device) -> float:
    """Mean milliseconds of ``reps`` calls of ``fn`` after the caller's
    warm-up: CUDA events on the card, the host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / reps


def compare(i16, i32) -> tuple[float, bool]:
    """(largest |i16 - i32| where the exact score is below SAT, whether
    every score meets the SAT rule)."""
    below = i32 < sw_cell.SAT
    diff = float((i16 - i32).abs()[below].max()) if bool(below.any()) else 0.0
    return diff, bool(sw_cell.sat_match(i16, i32).all())


def run(T: int, reps: int, device, lengths=LENGTHS, query_lengths=QUERY_LENGTHS,
        slot_sets=SLOT_SETS, inspect=None) -> list[dict]:
    """Run the A/B and print its lines; returns one dict a line: kind, L,
    rows, ms and GCUPS of each mode, max_diff and ok.  The pool is NQC
    rows and each slot's offset a multiple of FLAT_QUANT, read at the
    call.  ``inspect``, if given, is called after each line as
    ``inspect(line, inputs, scores)``: the call's inputs (a dict of
    ``tiles``, ``queries``, ``matrix``, ``params``, ``offs``, ``rtot``;
    ``offs`` and ``rtot`` None on a single line) and both modes' scores
    (``{"i32": ..., "i16": ...}``); nothing of them is kept."""
    cfg = make_scoring_config("blosum62")
    rng = np.random.default_rng(0)
    mat = cuda_lib.device_matrix(cfg.matrix, device)
    n = T * sw_cell.G * sw_cell.NSL
    rtot, quant = sw_col.NQC, sw_col.FLAT_QUANT
    lines = []

    def ab(label, kind, L, rows, cells, call, inputs):
        scores, ms = {}, {}
        for exact in (True, False):
            mode = "i32" if exact else "i16"
            scores[mode] = call(exact)  # the warm-up
            ms[mode] = mean_ms(lambda: call(exact), reps, device)
        gcups = {mode: cells / 1e6 / ms[mode] for mode in ms}
        diff, ok = compare(scores["i16"], scores["i32"])
        print(f"{label}: i32 {gcups['i32']:.1f} GCUPS, i16 {gcups['i16']:.1f} GCUPS "
              f"({gcups['i16'] / gcups['i32'] - 1:+.1%}), max |i16 - i32| under the SAT rule "
              f"{diff:g} [{'OK' if ok else 'MISMATCH'}]", flush=True)
        lines.append({"kind": kind, "L": L, "rows": list(rows), "ms_i32": ms["i32"],
                      "ms_i16": ms["i16"], "gcups_i32": gcups["i32"], "gcups_i16": gcups["i16"],
                      "max_diff": diff, "ok": ok})
        if inspect is not None:
            inspect(lines[-1], {"matrix": mat, **inputs}, scores)

    for L in lengths:
        data = rng.integers(0, 20, size=(n, L)).astype(np.int8)
        x = data.reshape(T, sw_cell.G * sw_cell.NSL, L).transpose(0, 2, 1)
        tiles = cuda_lib.to_device(np.ascontiguousarray(x.reshape(T, L, sw_cell.G, sw_cell.NSL)),
                                   device)
        del data, x

        # The single-query kernel (the >NQC-aa ladder path runs it).
        for qlen in query_lengths:
            qpad, nq_pad = sw_col.pad_query_chunk(rng.integers(0, 20, size=qlen), pad=cfg.pad_code)
            q = cuda_lib.to_device(qpad, device)
            params = (nq_pad, cfg.gop, cfg.gex, 0)
            ab(f"single L={L} q={qlen}", "single", L, (qlen,), float(qlen) * L * n,
               lambda exact: sw_col.score_bucket_col(tiles, q, mat, params, exact=exact),
               {"tiles": tiles, "queries": q, "params": params, "offs": None, "rtot": None})

        # The flat-pool batch kernel (the batch path runs it).
        for qlens in slot_sets:
            queries = np.full((len(qlens), max(qlens)), cfg.pad_code, np.int32)
            pads, offs, off = [], [], 0
            for s, ql in enumerate(qlens):
                queries[s, :ql] = rng.integers(0, 20, size=ql)
                pads.append(sw_col.padded_rows(ql))
                offs.append(off)
                off += -(-pads[-1] // quant) * quant
            qd = cuda_lib.to_device(queries, device)
            params = (0, cfg.gop, cfg.gex, 0, *pads)
            offs = tuple(offs)
            ab(f"flat  L={L} slots={list(qlens)}", "flat", L, qlens, float(sum(qlens)) * L * n,
               lambda exact: sw_col.score_bucket_col_flat(tiles, qd, mat, params, offs,
                                                          rtot=rtot, exact=exact),
               {"tiles": tiles, "queries": qd, "params": params, "offs": offs, "rtot": rtot})
    return lines


def main(argv=None, inspect=None) -> int:
    T, reps, device = parse_argv(sys.argv[1:] if argv is None else argv)
    lines = run(T, reps, device, inspect=inspect)
    return 0 if all(line["ok"] for line in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
