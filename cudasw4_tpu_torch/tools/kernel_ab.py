"""Time the kernels of two checkouts of the port on one card, in turns, and
compare their machine code.

    python3 -m cudasw4_tpu_torch.tools.kernel_ab DIR_A DIR_B [--rounds N]
    python3 -m cudasw4_tpu_torch.tools.kernel_ab --sweep DIR

Each round runs A, B, B, A, every run in a fresh process that builds its
checkout's kernels (``cuda_lib.lib()``) and times the cell, row and col
kernels (cell and col also in int16 state), the manual-staging and pair
kernels, and the batch kernels on the same seeded inputs: CUDA events,
the mean of 5 launches after one warm-up (the batch kernels' int16 modes
too, where the checkout has them).  Prints one JSON line per run,
with the card's name and power limit, then a summary line with each
kernel's median per checkout and the seconds each checkout's first run
took to build and load its library, then one line naming the kernels
whose SASS (``cuobjdump -sass`` of the two libraries, the anonymous
namespace's hashed names stripped) is identical in both checkouts and
those whose SASS differs, with the SASS line counts (A, B) of the
kernels both libraries hold.

``--sweep`` times, in one checkout, every (G, R) instance of the cell
kernels that its library holds (``cuda_lib.cell_shapes``) at L = G x R
and the Swiss-Prot-scale tile count of that length (``sweep_tiles``), in
exact state in int32 lanes (``sw_cell_kernel``) and in s16x2 lanes
(``sw_cell16_kernel``), with the 464-aa query, for the 21-letter and the
26-letter matrix; then B4 both ways at BATCH14's slots on [12, 640] and
[1, 64].  One JSON line: each row's milliseconds and s16x2 over int32.
Needs CUDA.
"""

from __future__ import annotations

import inspect
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

#: (kernel, tiles shape, query rows): the main-path shapes of the
#: Swiss-Prot-scale database's buckets with the 464-aa query (the cell
#: buckets of L = 64, 128, 256 and the largest, 640, at their tile counts;
#: the largest row and col buckets), the largest cell bucket in int16
#: state ("cell16") and through the manual-staging kernel in both states
#: ("manual", "manual16") and the pair kernel (P = 2), row buckets on the row kernel's cell route at (16, 32) and on
#: its col route (L = 2304), the top col bucket with the 144-aa query and
#: in int16 state ("col16"), and one full col chunk.
CASES = (
    ("cell", (12, 640, 32, 128), 464),
    ("cell", (1, 64, 32, 128), 464),
    ("cell", (5, 128, 32, 128), 464),
    ("cell", (12, 256, 32, 128), 464),
    ("cell16", (12, 640, 32, 128), 464),
    ("manual", (12, 640, 32, 128), 464),
    ("manual16", (12, 640, 32, 128), 464),
    ("pair", (12, 640, 32, 128), 464),
    ("row", (11, 48, 128), 464),
    ("row", (16, 512, 128), 464),
    ("row", (4, 2304, 128), 464),
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

#: The cell buckets of the Swiss-Prot-scale database (swbench's ``sprot``):
#: L and tiles.
SPROT_CELL_TILES = {64: 1, 80: 2, 96: 3, 112: 4, 128: 5, 160: 11, 192: 12, 224: 12,
                    256: 12, 320: 20, 384: 16, 448: 12, 512: 9, 640: 12, 768: 7}


def sweep_tiles(L: int) -> int:
    """The sweep's tile count at L: that of the shortest Swiss-Prot cell
    bucket at least L long (its instance runs such tiles), 1 below 64."""
    return SPROT_CELL_TILES[min((b for b in SPROT_CELL_TILES if b >= L), default=768)]


def _child(tree: str) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from cudasw4_tpu_torch import make_scoring_config
    from cudasw4_tpu_torch.ops import cuda_lib, sw_cell, sw_col, sw_row
    from cudasw4_tpu_torch.tools.pairbench import score_pair

    assert cuda_lib.__file__.startswith(tree), cuda_lib.__file__
    out = {"library": str(cuda_lib.library_path())}
    built = not cuda_lib.library_path().exists()
    t0 = time.perf_counter()
    cuda_lib.lib()
    if built:
        out["build_seconds"] = time.perf_counter() - t0
    cfg = make_scoring_config("blosum62")
    m = torch.as_tensor(cfg.matrix.astype(np.int32).reshape(-1)).cuda()
    # The range ``cuda_lib.device_matrix`` notes, so that no timed launch
    # reads it from the card; a tree older than that helper ignores it.
    m.score_range = (int(cfg.matrix.min()), int(cfg.matrix.max()))
    rng = np.random.default_rng(1)
    for kind, shape, nq in CASES:
        t = _tiles(rng, shape, cfg.pad_code)
        q = np.full(max(nq, 3072 if kind.startswith("col") else 8192), cfg.pad_code, np.int32)
        q[:nq] = rng.integers(0, 20, size=nq)
        q = torch.as_tensor(q).cuda()
        p = (nq, cfg.gop, cfg.gex, nq)
        fn = {"cell": sw_cell.score_bucket_cell, "row": sw_row.score_bucket_row,
              "cell16": lambda *a: sw_cell.score_bucket_cell(*a, exact=False),
              "manual": sw_cell.score_bucket_cell_manual,
              "manual16": lambda *a: sw_cell.score_bucket_cell_manual(*a, exact=False),
              "pair": lambda *a: score_pair(*a, P=2),
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
        # The int16 mode, where the checkout's wrapper has one.
        if "exact" in inspect.signature(fn).parameters:
            out[f"{name}16 {list(shape)} x{sum(rows)}"] = _ms(
                lambda *a: fn(*a, exact=False), *args)
    return out


def _sweep(tree: str) -> dict:
    """Milliseconds of every compiled cell instance (G, R) at L = G x R and
    ``sweep_tiles(L)`` tiles, exact, in int32 lanes and in s16x2 lanes,
    with the 464-aa query, at A = 21 and A = 26; then B4 both ways."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from cudasw4_tpu_torch import make_scoring_config
    from cudasw4_tpu_torch.ops import cuda_lib, sw_cell

    rng = np.random.default_rng(1)
    shapes = cuda_lib.cell_shapes()
    rows = []
    for mat in ("blosum62", "blosum62_full"):
        cfg = make_scoring_config(mat)
        A = cfg.alphabet_size
        m = cuda_lib.device_matrix(cfg.matrix, "cuda")
        q = torch.as_tensor(rng.integers(0, 20, size=(1, 464)).astype(np.int32)).cuda()
        for g, r in shapes:
            L, T = g * r, sweep_tiles(g * r)
            t = _tiles(rng, (T, L, 32, 128), cfg.pad_code)
            ms = {lanes: _ms(cuda_lib.launch_cell, sw_cell.score_bucket_cell, kernel, t, q, m,
                             cfg.gop, cfg.gex, 464, (g, r))
                  for lanes, kernel in (("int32", "sw_cell_kernel"), ("s16x2", "sw_cell16_kernel"))}
            rows.append({"kernel": "B1", "A": A, "G": g, "R": r, "L": L, "T": T, **ms,
                         "ratio": ms["s16x2"] / ms["int32"]})
        qb = np.full((len(BATCH14), 3072), cfg.pad_code, np.int32)
        for s, n in enumerate(BATCH14):
            qb[s, :n] = rng.integers(0, 20, size=n)
        qb = torch.as_tensor(qb).cuda()
        for T, L in ((12, 640), (1, 64)):
            t = _tiles(rng, (T, L, 32, 128), cfg.pad_code)
            ms = {lanes: _ms(cuda_lib.launch_cell, sw_cell.score_bucket_cell_batch, kernel, t, qb,
                             m, cfg.gop, cfg.gex, list(BATCH14), sw_cell.cell_shape(L))
                  for lanes, kernel in (("int32", "sw_cell_batch_kernel"),
                                        ("s16x2", "sw_cell16_kernel"))}
            rows.append({"kernel": "B4", "A": A, "shape": [T, L], "slots": len(BATCH14), **ms,
                         "ratio": ms["s16x2"] / ms["int32"]})
    return {"rows": rows}


#: Lines of cuobjdump's listing that belong to a cubin, not to a kernel:
#: the last kernel of each cubin is followed by the next cubin's header.
_CUBIN_LINES = ("Fatbin", "=====", "arch =", "code version", "host =", "compile_size",
                "code for", ".....")


def _sass(lib: str) -> dict:
    """Kernel -> SASS text of a built library, keyed by the mangled name
    from the kernel's own name on (the anonymous namespace's part differs
    between builds and units): each instruction and its encoding, with the
    code addresses stripped, runs of blanks collapsed (cuobjdump pads the
    columns to a cubin's widest line, and the library is several cubins)
    and the cubin header lines dropped."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    res = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True)
    kernels = {}
    for part in res.stdout.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        key = re.search(r"\d+(sw_\w*?_kernel.*)$", name.strip())
        lines = (" ".join(line.split()) for line in re.sub(r"/\*[0-9a-f]{4,}\*/", "", body).splitlines())
        kernels[key.group(1) if key else name.strip()] = "\n".join(
            line for line in lines if line and not line.startswith(_CUBIN_LINES))
    return kernels


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
    if argv and argv[0] == "--sweep-child":
        print(json.dumps(_sweep(argv[1])), flush=True)
        return 0
    rounds = 1
    if "--rounds" in argv:
        i = argv.index("--rounds")
        rounds = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    if len(argv) == 2 and argv[0] == "--sweep":
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--sweep-child", os.path.abspath(argv[1])],
            capture_output=True, text=True, check=True,
        )
        print(json.dumps({"card": card, "sweep_ms": json.loads(res.stdout.strip().splitlines()[-1])}),
              flush=True)
        return 0
    argv = [os.path.abspath(tree) for tree in argv]
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
    notime = ("library", "build_seconds")
    print(json.dumps({"card": card, "median_ms": {
        tree: {k: statistics.median(r[k] for r in rs if k in r) for k in rs[0] if k not in notime}
        for tree, rs in runs.items()
    }, "build_seconds": {tree: [r["build_seconds"] for r in rs if "build_seconds" in r]
                         for tree, rs in runs.items()}}), flush=True)
    a, b = (_sass(runs[tree][0]["library"]) for tree in argv)
    same = sorted(k for k in a if k in b and a[k] == b[k])
    print(json.dumps({"sass_identical": same,
                      "sass_differs_or_new": sorted(set(a) ^ set(b) | {k for k in a if k in b and a[k] != b[k]}),
                      "sass_lines_differing": {k: [a[k].count("\n"), b[k].count("\n")]
                                               for k in a if k in b and a[k] != b[k]}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
