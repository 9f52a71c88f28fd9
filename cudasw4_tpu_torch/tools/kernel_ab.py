"""Time the single-query kernels of two checkouts of the port on one card,
in turns.

    python3 -m cudasw4_tpu_torch.tools.kernel_ab DIR_A DIR_B [--rounds N]

Each round runs A, B, B, A, every run in a fresh process that builds its
checkout's kernels (``cuda_lib.lib()``) and times the cell, row and col
kernels (col also in int16 state) on the same seeded inputs, and the
batch kernels: CUDA events, the mean of 5 launches after one warm-up.
Prints one JSON line per run, with the card's name and
power limit, then a summary line with each kernel's median per checkout.
Needs CUDA.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

#: (kernel, tiles shape, query rows): the main-path shapes of the
#: Swiss-Prot-scale database's largest buckets with the 464-aa query, the
#: top col bucket with the 144-aa query and in int16 state ("col16"), and
#: one full col chunk.
CASES = (
    ("cell", (12, 640, 32, 128), 464),
    ("row", (11, 48, 128), 464),
    ("col", (1, 5632, 32, 128), 464),
    ("col", (1, 5632, 32, 128), 144),
    ("col16", (1, 5632, 32, 128), 464),
    ("col", (2, 1024, 32, 128), 3072),
)

#: Batch kernels, timed where the checkout has them: the largest cell
#: bucket with the reference set's batch of 14, and the largest col bucket
#: with the widest pass of its plan (padded rows, pool offsets).
BATCH14 = (144, 189, 222, 375, 464, 567, 657, 729, 850, 1000, 1500, 2005, 2504, 3005)
WIDEST_PASS = ((736, 664, 376, 224, 192, 144), (0, 768, 1536, 1920, 2176, 2432))


def _child(tree: str) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from cudasw4_tpu_torch import make_scoring_config
    from cudasw4_tpu_torch.ops import cuda_lib, sw_cell, sw_col, sw_row

    assert cuda_lib.__file__.startswith(tree), cuda_lib.__file__
    cuda_lib.lib()
    cfg = make_scoring_config("blosum62")
    m = torch.as_tensor(cfg.matrix.astype(np.int32).reshape(-1)).cuda()
    rng = np.random.default_rng(1)
    out = {}
    for kind, shape, nq in CASES:
        t = _tiles(rng, shape, cfg.pad_code)
        q = np.full(max(nq, 3072 if kind.startswith("col") else 8192), cfg.pad_code, np.int32)
        q[:nq] = rng.integers(0, 20, size=nq)
        q = torch.as_tensor(q).cuda()
        p = (nq, cfg.gop, cfg.gex, nq)
        fn = {"cell": sw_cell.score_bucket_cell, "row": sw_row.score_bucket_row,
              "col": sw_col.score_bucket_col,
              "col16": lambda *a: sw_col.score_bucket_col(*a, exact=False)}[kind]
        out[f"{kind} {list(shape)} x{nq}"] = _ms(fn, t, q, m, p)
    for name, shape, rows in (("cell_batch", (12, 640, 32, 128), BATCH14),
                              ("col_flat", (1, 5632, 32, 128), WIDEST_PASS[0]),
                              ("col_fused", (1, 5632, 32, 128), WIDEST_PASS[0])):
        t = _tiles(rng, shape, cfg.pad_code)
        q = np.full((len(rows), 3072), cfg.pad_code, np.int32)
        for s, n in enumerate(rows):
            q[s, :n] = rng.integers(0, 20, size=n)
        q = torch.as_tensor(q).cuda()
        p = (0, cfg.gop, cfg.gex, 0, *rows)
        if name == "cell_batch":
            args, fn = (t, q, m, p), sw_cell.score_bucket_cell_batch
        elif name == "col_flat":
            args, fn = (t, q, m, p, WIDEST_PASS[1]), sw_col.score_bucket_col_flat
        else:
            args, fn = (t, q, m, p), sw_col.score_bucket_col_flat_fused
        out[f"{name} {list(shape)} x{sum(rows)}"] = _ms(fn, *args)
    return out


def _tiles(rng, shape, pad):
    """Seeded subject codes on the card, ragged lengths, pad past each."""
    import numpy as np
    import torch

    T, L = shape[0], shape[1]
    ns = int(np.prod(shape[2:]))
    x = rng.integers(0, 20, size=(T, L, ns), dtype=np.int8)
    lens = rng.integers(1, L + 1, size=(T, 1, ns))
    x[np.arange(L)[None, :, None] >= lens] = pad
    return torch.as_tensor(x.reshape(shape)).cuda()


def _ms(fn, *args) -> float:
    """Mean milliseconds of 5 calls after one warm-up (CUDA events)."""
    import torch

    fn(*args)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(5):
        fn(*args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / 5


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--child":
        print(json.dumps(_child(argv[1])), flush=True)
        return 0
    rounds = 1
    if "--rounds" in argv:
        i = argv.index("--rounds")
        rounds = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    argv = [os.path.abspath(tree) for tree in argv]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    runs = {tree: [] for tree in argv}
    for _ in range(rounds):
        for tree in (argv[0], argv[1], argv[1], argv[0]):
            # Run this file as a script, so the child imports the package
            # from ``tree`` alone.
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", tree],
                capture_output=True, text=True, check=True,
            )
            times = json.loads(res.stdout.strip().splitlines()[-1])
            runs[tree].append(times)
            print(json.dumps({"tree": tree, "card": card, "ms": times}), flush=True)
    print(json.dumps({"card": card, "median_ms": {
        tree: {k: statistics.median(r[k] for r in rs if k in r) for k in rs[0]}
        for tree, rs in runs.items()
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
