"""A/B of the col kernels' passes: each warp stopping at its own subject's
length (the tiles' lengths given, as the engine gives them) against every
warp sweeping the bucket's padded L (no lengths), on the top col tile of
the benchmark's Swiss-Prot-scale database.

Usage, from the root of a checkout:
    python -m cudasw4_tpu_torch.tools.colpass [reps] [--full L]

The tile is the last of the largest col bucket that ``plan_buckets`` makes
of swbench's ``sprot`` lengths with ``file21``'s members (``top_col_tile``):
random codes up to each subject's length, the pad code past it.  It runs
B3 (``score_bucket_col``) with the 464-aa query, and B5 and B6
(``score_bucket_col_flat`` and ``score_bucket_col_flat_fused``) with six
slots of 144 to 736 padded rows in one flat pass (2,336 rows), each in
exact and int16 state.  For each it checks that the
scores with lengths, without them and of the plain version (on the card)
are equal bit for bit, and times both launches in turns (without, with,
with, without; CUDA events, the mean of ``reps`` launches after one
warm-up, default 5; the better turn kept) and the plain version once.  The
bound is the kernel table's: 5.5 operations a real cell at 16.7 Top/s, two
cells an operation in int16 state.  Prints one JSON line per kernel, then
one with the card's name and power limit.  Needs CUDA; exits 1 if the
scores differ.

``--full L`` takes instead one tile of L columns (a multiple of 512) whose
every subject fills the bucket's passes (lengths drawn in (L - 512, L]
from ``np.random.default_rng(7)``): there the lengths save no pass, and
the two launches time what reading them and the reversed block order
cost.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..db.packing import plan_buckets
from ..ops import col_flat_plan, cuda_lib, sw_col
from ..substitution import make_scoring_config

#: Operations a real cell and the card's peak, the kernel table's bound.
OPS_PER_CELL, PEAK_OPS = 5.5, 16.7e12
#: The query of B3 and the padded rows of B5's and B6's six slots.
QUERY_ROWS = 464
SLOT_ROWS = (144, 192, 224, 376, 664, 736)


def top_col_tile(lengths) -> tuple[int, np.ndarray]:
    """(L, int32 [4096] subject lengths) of the last tile of the largest
    col bucket that ``plan_buckets`` makes of the sorted ``lengths``; the
    lanes past the bucket's last subject hold 0."""
    start, stop, L, ns, _ = [p for p in plan_buckets(np.asarray(lengths)) if p[4] == "col"][-1]
    first = start + (-(-(stop - start) // ns) - 1) * ns
    lens = np.zeros(ns, np.int32)
    lens[: stop - first] = lengths[first:stop]
    return L, lens


def sprot_lengths(root: Path) -> np.ndarray:
    """swbench's ``sprot`` lengths with ``file21``'s members."""
    sys.path.insert(0, str(root))
    from swbench import dbgen

    spec = json.loads((root / "swbench/configs/sprot.json").read_text())
    members = json.loads((root / "swbench/traffic/file21.json").read_text())
    return dbgen.model_lengths(spec, members["queries"]["member_lengths"])


def _once(fn):
    """(fn(), its milliseconds on the card)."""
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def _ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    full = None
    if "--full" in argv:
        i = argv.index("--full")
        full = int(argv[i + 1])
        del argv[i : i + 2]
    reps = int(argv[0]) if argv else 5
    dev = torch.device("cuda")
    cfg = make_scoring_config("blosum62")
    rng = np.random.default_rng(7)
    if full is None:
        L, lens = top_col_tile(sprot_lengths(Path.cwd()))
    else:
        L, lens = full, rng.integers(full - 511, full + 1, size=4096).astype(np.int32)
    x = rng.integers(0, 20, size=(L, lens.size)).astype(np.int8)
    x[np.arange(L)[:, None] >= lens[None, :]] = cfg.pad_code
    t = torch.as_tensor(x.reshape(1, L, 32, 128)).to(dev)
    cl = sw_col.ColLengths.place(lens[None], dev)
    m = cuda_lib.device_matrix(cfg.matrix.astype(np.int32).reshape(-1), dev)
    q = torch.full((sw_col.NQC,), cfg.pad_code, dtype=torch.int32)
    q[:QUERY_ROWS] = torch.as_tensor(rng.integers(0, 20, size=QUERY_ROWS))
    q = q.to(dev)
    (slots,) = [p for p in col_flat_plan(list(SLOT_ROWS), rtot=sw_col.NQC) if len(p) == 6]
    qs = torch.full((len(SLOT_ROWS), sw_col.NQC), cfg.pad_code, dtype=torch.int32)
    for i, n in enumerate(SLOT_ROWS):
        qs[i, :n] = torch.as_tensor(rng.integers(0, 20, size=n))
    idx, offs = [i for i, _ in slots], tuple(o for _, o in slots)
    qs = qs[idx].contiguous().to(dev)
    p5 = (0, cfg.gop, cfg.gex, 0, *(SLOT_ROWS[i] for i in idx))
    p3 = (QUERY_ROWS, cfg.gop, cfg.gex, QUERY_ROWS)
    cases = {
        "sw_col_kernel": (
            lambda exact, ln: sw_col.score_bucket_col(t, q, m, p3, exact=exact, lengths=ln),
            lambda exact: sw_col.score_bucket_col_plain(t, q, m, p3, exact=exact), QUERY_ROWS),
        "sw_col_flat_kernel": (
            lambda exact, ln: sw_col.score_bucket_col_flat(t, qs, m, p5, offs, rtot=sw_col.NQC,
                                                           exact=exact, lengths=ln),
            lambda exact: sw_col.score_bucket_col_flat_plain(t, qs, m, p5, exact), sum(SLOT_ROWS)),
        "sw_col_fused_kernel": (
            lambda exact, ln: sw_col.score_bucket_col_flat_fused(t, qs, m, p5, rtot=sw_col.NQC,
                                                                 exact=exact, lengths=ln),
            lambda exact: sw_col.score_bucket_col_flat_plain(t, qs, m, p5, exact), sum(SLOT_ROWS)),
    }
    real = int(lens.sum())
    ok = True
    for name, (fn, plain, rows) in cases.items():
        for exact in (True, False):
            want, plain_ms = _once(lambda: plain(exact))
            equal = torch.equal(fn(exact, cl), fn(exact, None)) and torch.equal(fn(exact, cl), want)
            ok &= equal
            turns = {"without": [], "with": []}
            for who in ("without", "with", "with", "without"):
                ln = cl if who == "with" else None
                turns[who].append(_ms(lambda: fn(exact, ln), reps))
            without, with_ = min(turns["without"]), min(turns["with"])
            bound = OPS_PER_CELL * real * rows / PEAK_OPS * 1e3 / (1 if exact else 2)
            print(json.dumps({
                "kernel": name if exact else name.replace("_kernel", "16_kernel"),
                "shape": list(t.shape), "rows": rows,
                "lengths": [int(lens[lens > 0].min()), int(lens.max())],
                "real_chars": real, "equal": equal, "ms": with_, "without_lengths_ms": without,
                "ratio": with_ / without, "plain_ms": plain_ms, "bound_ms": bound,
                "share": bound / with_, "share_without_lengths": bound / without, "turns": turns,
            }), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card, "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
