#!/usr/bin/env python3
"""Drive the cudasw4_tpu_torch port on one NVIDIA GPU and check it.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device:  the card's name and power limit (nvidia-smi), and the build
   of the CUDA kernels from csrc/ with nvcc.
2. kernels: each kernel (cell, row, col with its carry) against its plain
   PyTorch version on the card, exact equality of the integer scores, both
   alphabets; kernel, plain and bound times.
3. golden:  the port's makedb and align --tsv --top 10 on the golden
   fixtures, byte for byte against golden_top10.tsv and
   golden_top10_full.tsv.
4. sprot:   a Swiss-Prot-scale database (573,000 sequences, log-normal
   lengths, median 292, sigma 0.64, clipped to [11, 35000], ~205M
   residues, seed 42) through the port's makedb and align on a query
   ladder of 144..5478 residues: every reported hit re-scored by the
   vectorised oracle, the tie order, all 573k scores of the 144-aa query
   against the plain version, and the launch counters of the align run.
   Then the card's idle share over the same ladder, from a torch.profiler
   trace (kernel and copy intervals on the device).
5. kernels line: per kernel, its launches in phase 4 and its time, bound
   and plain time at the largest bucket of its kind in phase 4.

Bounds and per-kernel GCUPS count the DP cells the data needs: real query
rows times real subject residues.  The kernels also sweep the padding
after each subject (its matrix row is all negative, so it changes no
score); each line gives the padded cell count beside the real one.

Then the nvidia-smi line and, last, the contract line
{"ok": true, "device": {...}}.  Needs CUDA: without it, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

#: H100 SXM memory rate (NVIDIA data sheet) and the int32 lane count the
#: operation bound uses: 132 SMs x 64 int32 lanes x the SM clock.
HBM_BYTES_PER_S = 3.35e12
INT32_LANES = 132 * 64
#: int32 operations per DP cell: E (2 adds, 1 max), F (2 adds, 1 max),
#: H (1 add, 3 max), running max (1 max).
OPS_PER_CELL = 11

#: The Swiss-Prot length model (benchmarks/make_synthetic_db.py, "sprot").
SPROT_NUM, SPROT_MEDIAN, SPROT_SIGMA = 573_000, 292.0, 0.64
QUERY_LADDER = (144, 464, 1000, 3005, 5478)
AAS = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", dtype=np.uint8)

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events, one warm-up)."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(cells: float, nbytes: float, clock_mhz: float):
    """Least time the card could take: the larger of bytes over the memory
    rate and int32 operations over the int32 rate.  Returns (ms, by)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = cells * OPS_PER_CELL / (INT32_LANES * clock_mhz * 1e6) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def random_tiles(rng, shape, A, pad):
    """Subject codes in [0, A-1) with ragged lengths; the rest is pad.
    Returns (tiles on the card, real residues)."""
    T, L = shape[0], shape[1]
    ns = int(np.prod(shape[2:]))
    x = rng.integers(0, A - 1, size=(T, L, ns), dtype=np.int8)
    lens = rng.integers(1, L + 1, size=(T, 1, ns))
    x[np.arange(L)[None, :, None] >= lens] = pad
    return torch.as_tensor(x.reshape(shape)).cuda(), int(lens.sum())


def cell_counts(shape, nrows, real_rows, real_chars):
    """(real, padded) DP cells of one kernel call: real query rows x real
    subject residues, and every query row run x every tile position."""
    return real_rows * real_chars, nrows * int(np.prod(shape))


def query_block(rng, nq, cap, A, pad):
    q = np.full(cap, pad, np.int32)
    q[:nq] = rng.integers(0, A - 1, size=nq)
    return torch.as_tensor(q).cuda()


# --------------------------------------------------------------- phase 2

def phase_kernels(clock_mhz):
    from cudasw4_tpu_torch import make_scoring_config
    from cudasw4_tpu_torch.ops import sw_cell, sw_col, sw_row
    from cudasw4_tpu_torch.ops.sw_torch import sweep_tiles_torch

    rng = np.random.default_rng(7)
    rows = []

    def record(name, mat, shape, nq, real_nq, real_chars, got, want, ms, plain_ms,
               extra_bytes=0):
        check(torch.equal(got, want), f"{name} {mat} {shape}: kernel != plain")
        real, padded = cell_counts(shape, nq, real_nq, real_chars)
        out_bytes = shape[0] * int(np.prod(shape[2:])) * 4
        b_ms, by = bound(real, int(np.prod(shape)) + 4 * nq + out_bytes + extra_bytes, clock_mhz)
        rows.append({
            "check": name, "mat": mat, "shape": list(shape), "nq": nq, "equal": True,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "cells_real": real, "cells_padded": padded,
            "gcups_real": real / ms / 1e6, "gcups_padded": padded / ms / 1e6,
        })

    for mat in ("blosum62", "blosum62_full"):
        cfg = make_scoring_config(mat)
        A, pad = cfg.alphabet_size, cfg.pad_code
        m = torch.as_tensor(cfg.matrix.astype(np.int32).reshape(-1)).cuda()
        cell_shapes = [(8, 256, 32, 128)] + ([(4, 768, 32, 128)] if mat == "blosum62" else [])
        for shape in cell_shapes:
            t, real_chars = random_tiles(rng, shape, A, pad)
            q = query_block(rng, 464, sw_cell.QCAP, A, pad)
            p = (464, cfg.gop, cfg.gex, 464)
            got = sw_cell.score_bucket_cell(t, q, m, p)
            want = sw_cell.score_bucket_cell_plain(t, q, m, p)
            ms = cuda_ms(lambda: sw_cell.score_bucket_cell(t, q, m, p))
            pms = cuda_ms(lambda: sw_cell.score_bucket_cell_plain(t, q, m, p), reps=1)
            record("B1 cell", mat, shape, 464, 464, real_chars, got, want, ms, pms)
        row_shapes = [(16, 512, 128)] + ([(4, 2304, 128)] if mat == "blosum62" else [])
        for shape in row_shapes:
            t, real_chars = random_tiles(rng, shape, A, pad)
            q = query_block(rng, 464, sw_cell.QCAP, A, pad)
            p = (464, cfg.gop, cfg.gex, 464)
            got = sw_row.score_bucket_row(t, q, m, p)
            want = sw_row.score_bucket_row_plain(t, q, m, p)
            ms = cuda_ms(lambda: sw_row.score_bucket_row(t, q, m, p))
            pms = cuda_ms(lambda: sw_row.score_bucket_row_plain(t, q, m, p), reps=1)
            record("B2 row", mat, shape, 464, 464, real_chars, got, want, ms, pms)

        # B3: a 5478-aa query over L=1024 col tiles: two NQC chunks with
        # the H/F carry, each chunk and its carried state against the
        # plain version; then the whole query through the any-length
        # function with one-tile groups against one plain sweep.
        shape = (2, 1024, 32, 128)
        t, real_chars = random_tiles(rng, shape, A, pad)
        codes = rng.integers(0, A - 1, size=5478).astype(np.int8)
        chunks = [codes[:sw_col.NQC], codes[sw_col.NQC:]]
        state = state_w = None
        for k, chunk in enumerate(chunks):
            qp, nq_pad = sw_col.pad_query_chunk(chunk, pad=pad)
            q = torch.as_tensor(qp).cuda()
            p = (nq_pad, cfg.gop, cfg.gex, 0)
            emit_state = k == 0
            got = sw_col.score_bucket_col(t, q, m, p, state_in=state,
                                          take_init=state is not None, emit_state=emit_state)
            want = sw_col.score_bucket_col_plain(t, q, m, p, state_in=state_w, emit_state=emit_state)
            if emit_state:
                (got, state), (want, state_w) = got, want
                check(torch.equal(state[0], state_w[0]) and torch.equal(state[1], state_w[1]),
                      f"B3 {mat}: carried H/F state != plain")
            st, st_w = state, state_w
            ms = cuda_ms(lambda: sw_col.score_bucket_col(
                t, q, m, p, state_in=st if k else None, take_init=bool(k), emit_state=k == 0))
            pms = cuda_ms(lambda: sw_col.score_bucket_col_plain(
                t, q, m, p, state_in=st_w if k else None, emit_state=k == 0), reps=1)
            io_bytes = 8 * int(np.prod(shape))  # carry out (chunk 0) or in (chunk 1)
            record(f"B3 col chunk {k}", mat, shape, nq_pad, len(chunk), real_chars,
                   got, want, ms, pms, io_bytes)
        got = sw_col.score_bucket_col_any_query(t, codes, m, cfg.gop, cfg.gex, pad=pad, temp_bytes=1)
        best, _, _ = sweep_tiles_torch(t.reshape(2, 1024, 4096), codes.tolist(),
                                       m.view(A, A), cfg.gop, cfg.gex)
        check(torch.equal(got, best.float()), f"B3 any-query one-tile groups {mat}: != plain")
        rows.append({"check": "B3 col any-query, one-tile groups", "mat": mat,
                     "shape": list(shape), "nq": 5478, "equal": True})
    for r in rows:
        emit({"phase": "kernels", **r})


# --------------------------------------------------------------- phase 3

def run_cli(module, argv):
    """Run a CLI entry point in this process; returns (rc, stdout text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.run(argv)
    return rc, buf.getvalue()


def phase_golden():
    from cudasw4_tpu_torch.cli import align, makedb

    fix = os.path.join(REPO, "tests", "fixtures")
    prefix = os.path.join(WORK, "golden", "gdb")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    rc, _ = run_cli(makedb, [os.path.join(fix, "golden_db.fa"), prefix])
    check(rc == 0, "golden makedb failed")
    for mat, golden in (("blosum62", "golden_top10.tsv"), ("blosum62_full", "golden_top10_full.tsv")):
        rc, out = run_cli(align, [
            "--query", os.path.join(fix, "golden_queries.fa"), "--db", prefix,
            "--top", "10", "--tsv", "--mat", mat,
        ])
        check(rc == 0, f"golden align {mat} failed")
        got = "".join(
            line + "\n" for line in out.splitlines()
            if line and (line[0].isdigit() or line.startswith("Query number"))
        )
        with open(os.path.join(fix, golden)) as f:
            check(got == f.read(), f"golden TSV {mat} differs from {golden}")
    emit({"phase": "golden", "tsv_equal": ["blosum62", "blosum62_full"]})


# --------------------------------------------------------------- phase 4

def sprot_chunks(seed=42, chunk=20_000):
    """The Swiss-Prot length model of benchmarks/make_synthetic_db.py (same
    draws, same order): yields (first record id, lengths int64 [n], the
    chunk's residues as one uint8 blob) per chunk of records."""
    rng = np.random.default_rng(seed)
    for base in range(0, SPROT_NUM, chunk):
        n = min(chunk, SPROT_NUM - base)
        lens = np.clip(rng.lognormal(np.log(SPROT_MEDIAN), SPROT_SIGMA, size=n),
                       11, 35000).astype(np.int64)
        yield base, lens, AAS[rng.integers(0, 20, size=int(lens.sum()))]


def write_sprot_fasta(path, seed=42):
    """Write the Swiss-Prot-scale FASTA; returns the residue count."""
    total = 0
    with open(path, "wb", buffering=1 << 20) as f:
        for base, lens, blob in sprot_chunks(seed):
            total += int(lens.sum())
            out = bytearray()
            pos = 0
            for i in range(len(lens)):
                ln = int(lens[i])
                out += b">syn%d len %d\n" % (base + i, ln)
                out += blob[pos : pos + ln].tobytes()
                out += b"\n"
                pos += ln
            f.write(out)
    return total


def write_queries(path, seed=42):
    rng = np.random.default_rng(seed)
    seqs = []
    with open(path, "w") as f:
        for i, ln in enumerate(QUERY_LADDER):
            seq = AAS[rng.integers(0, 20, ln)].tobytes().decode()
            seqs.append(seq)
            f.write(f">ladder{i} length {ln}\n{seq}\n")
    return seqs


def reset_counts():
    from cudasw4_tpu_torch.ops import sw_cell, sw_col, sw_row

    for fn in (sw_cell.score_bucket_cell, sw_row.score_bucket_row, sw_col.score_bucket_col):
        fn.launches = 0
        fn.plain_calls = 0


def read_counts():
    from cudasw4_tpu_torch.ops import sw_cell, sw_col, sw_row

    return {
        name: (fn.launches, fn.plain_calls)
        for name, fn in (("cell", sw_cell.score_bucket_cell),
                         ("row", sw_row.score_bucket_row),
                         ("col", sw_col.score_bucket_col))
    }


def device_idle_share(run):
    """Trace ``run`` with torch.profiler and measure the card's idle share:
    1 - (union of the device's kernel, copy and set intervals) / (first
    device start to last device end).  Returns a dict with the share, the
    spans in microseconds and the kernel launches (the port's by name,
    PyTorch's as "other"); the share is None when the trace holds no
    device events."""
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(WORK, "ladder_trace.json")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans, names = [], {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
            if e["cat"] == "kernel":
                m = re.search(r"\bsw_\w+_kernel\b", e["name"])
                name = m.group(0) if m else "other"
                names[name] = names.get(name, 0) + 1
    if not spans:
        return {"device_idle_share": None, "reason": "no device events in the trace"}
    spans.sort()
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    span = max(b for _, b in spans) - spans[0][0]
    return {"device_idle_share": 1.0 - busy / span, "device_busy_us": busy,
            "device_span_us": span, "kernels": names}


def phase_sprot(clock_mhz):
    from cudasw4_tpu_torch import make_scoring_config
    from cudasw4_tpu_torch.cli import align, makedb
    from cudasw4_tpu_torch.constants import encode
    from cudasw4_tpu_torch.db.format import load_db
    from cudasw4_tpu_torch.engine import SearchEngine
    from cudasw4_tpu_torch.ops import oracle, score_bucket, sw_cell, sw_col, sw_row
    from cudasw4_tpu_torch.ops.sw_torch import score_tiles_torch

    d = os.path.join(WORK, "sprot")
    os.makedirs(d, exist_ok=True)
    fasta, prefix = os.path.join(d, "sprot.fa"), os.path.join(d, "sprot")
    qfile, tsv = os.path.join(d, "ladder.fa"), os.path.join(d, "hits.tsv")
    t0 = time.perf_counter()
    residues = write_sprot_fasta(fasta)
    queries = write_queries(qfile)
    t_fasta = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc, _ = run_cli(makedb, [fasta, prefix])
    check(rc == 0, "sprot makedb failed")
    t_makedb = time.perf_counter() - t0

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc, out = run_cli(align, [
        "--query", qfile, "--db", prefix, "--top", "10", "--tsv", "--verbose", "--of", tsv,
    ])
    t_align = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, "sprot align failed")
    for name, (launches, plain) in counts.items():
        check(launches > 0, f"the {name} kernel never launched on the main path")
        check(plain == 0, f"the {name} plain version ran {plain} times on the main path")
    per_query = [
        (float(a), float(b)) for a, b in
        (line.split("Scan time: ")[1].replace(" GCUPS", "").split(" s, ")
         for line in out.splitlines() if "Scan time: " in line)
    ]
    total_line = [line for line in out.splitlines() if line.startswith("Total time:")][0]
    total_s, total_gcups = (float(v) for v in
                            total_line.replace("Total time: ", "").replace(" GCUPS", "").split(" s, "))
    check(len(per_query) == len(queries), "align reported a wrong number of queries")

    # Every reported hit against the vectorised oracle, and the tie order.
    db = load_db(prefix)
    cfg = make_scoring_config("blosum62")
    hits: dict[int, list] = {}
    with open(tsv) as f:
        next(f)
        for line in f:
            c = line.rstrip("\n").split("\t")
            hits.setdefault(int(c[0]), []).append((int(c[4]), int(c[7])))
    check(sorted(hits) == list(range(len(queries))), "TSV lacks some queries")
    for qi, hs in hits.items():
        check(len(hs) == 10, f"query {qi}: {len(hs)} hits, expected 10")
        check(hs == sorted(hs, key=lambda h: (-h[0], h[1])),
              f"query {qi}: hits not in (descending score, ascending id) order")
        subs = [db.get_sequence(r) for _, r in hs]
        block = np.full((len(subs), max(len(s) for s in subs)), cfg.pad_code, np.int8)
        for k, s in enumerate(subs):
            block[k, : len(s)] = s
        want = oracle.sw_score_rowvec(encode(queries[qi]), block, cfg.matrix, cfg.gop, cfg.gex)
        check([h[0] for h in hs] == [int(v) for v in want],
              f"query {qi}: reported scores differ from the oracle")

    # All scores of the 144-aa query against the plain version, and the
    # per-kernel timings at the largest bucket of each kind.
    eng = SearchEngine(scoring=cfg, num_top=10)
    eng.set_database(db)
    codes = encode(queries[0])
    got = eng.slot_scores(codes)
    qpad, params = eng._single_qpad(codes)
    qdev = torch.as_tensor(qpad).cuda()
    mat = eng._matrix_flat.view(21, 21)
    want = torch.cat([
        score_tiles_torch(t.reshape(t.shape[0], t.shape[1], -1), qdev, mat,
                          cfg.gop, cfg.gex, len(codes)).reshape(-1)
        for t in eng._bucket_tiles
    ])
    valid = eng._valid
    n_equal = int((got[valid] == want[valid]).sum())
    check(n_equal == db.num_sequences,
          f"144-aa query: {db.num_sequences - n_equal} of {db.num_sequences} scores differ from plain")

    kernels = []
    mid = encode(queries[1])  # the 464-aa query: one col chunk
    qp, prm = eng._single_qpad(mid)
    qm = torch.as_tensor(qp).cuda()
    wrappers = {
        "cell": (sw_cell.score_bucket_cell, sw_cell.score_bucket_cell_plain,
                 "cudasw4_tpu/ops/sw_pallas_cell.py:506", "sw_cell_kernel"),
        "row": (sw_row.score_bucket_row, sw_row.score_bucket_row_plain,
                "cudasw4_tpu/ops/sw_pallas.py:138", "sw_row_kernel"),
        "col": (sw_col.score_bucket_col, sw_col.score_bucket_col_plain,
                "cudasw4_tpu/ops/sw_pallas_col.py:220", "sw_col_kernel"),
    }
    for kind, (fn, plain, replaces, kname) in wrappers.items():
        i = max((k for k, b in enumerate(eng.packed.buckets) if b.kernel == kind),
                key=lambda k: eng.packed.buckets[k].tiles.size)
        t = eng._bucket_tiles[i]
        if kind == "col":
            nrows = int(prm[3])
            p = (nrows, int(prm[1]), int(prm[2]), nrows)
            q = qm[: sw_col.NQC]
        else:
            nrows, p, q = len(mid), prm, qm
        a = fn(t, q, eng._matrix_flat, p)
        b = plain(t, q, eng._matrix_flat, p)
        err = float((a - b).abs().max())
        ms = cuda_ms(lambda: fn(t, q, eng._matrix_flat, p))
        pms = cuda_ms(lambda: plain(t, q, eng._matrix_flat, p), reps=1)
        shape = tuple(t.shape)
        real, padded = cell_counts(shape, nrows, len(mid), int(eng.packed.buckets[i].lengths.sum()))
        slots = shape[0] * int(np.prod(shape[2:]))
        b_ms, by = bound(real, t.numel() + 4 * nrows + 4 * slots, clock_mhz)
        kernels.append({
            "name": kname, "route": "cuda", "source": "cudasw4_tpu_torch/csrc/sw_tiles.cu",
            "replaces": replaces, "launches": counts[kind][0], "max_abs_err": err,
            "ms": ms, "plain_ms": pms, "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "equal": err == 0.0, "shape": list(shape), "nq": nrows,
            "cells_real": real, "cells_padded": padded,
            "gcups_real": real / ms / 1e6, "gcups_padded": padded / ms / 1e6,
        })
        check(err == 0.0, f"{kname} differs from plain at the main-path shape {tuple(t.shape)}")

    # Where a query's device time goes: each bucket timed alone (CUDA
    # events), summed by kernel kind, per ladder query.
    breakdown = {}
    for seq in queries:
        c = encode(seq)
        qp, prm = eng._single_qpad(c)
        qd = torch.as_tensor(qp).cuda()
        by_kind = {}
        for t, b in zip(eng._bucket_tiles, eng.packed.buckets):
            if b.kernel == "col" and int(prm[3]) > sw_col.NQC:
                def fn(t=t):
                    return sw_col.score_bucket_col_any_query(
                        t, c, eng._matrix_flat, cfg.gop, cfg.gex, pad=cfg.pad_code)
            else:
                def fn(t=t, kind=b.kernel):
                    return score_bucket(t, qd, eng._matrix_flat, prm, kind)
            by_kind[b.kernel] = by_kind.get(b.kernel, 0.0) + cuda_ms(fn, reps=1)
        breakdown[len(c)] = by_kind

    profiled = device_idle_share(lambda: list(eng.scan_many(queries)))

    kinds = {}
    for b in eng.packed.buckets:
        kinds[b.kernel] = kinds.get(b.kernel, 0) + 1
    emit({
        "phase": "sprot", "sequences": db.num_sequences, "residues": residues,
        "buckets": kinds, "padded_db_bytes": eng.packed.total_padded_chars,
        "query_lengths": list(QUERY_LADDER),
        "query_seconds": [s for s, _ in per_query], "query_gcups": [g for _, g in per_query],
        "total_seconds": total_s, "total_gcups": total_gcups,
        "stream_occupancy_between_queries": sum(q for q, _ in per_query) / total_s,
        "bucket_ms_by_kind": breakdown,
        "profiled_ladder": profiled,
        "align_run_seconds": t_align, "makedb_seconds": t_makedb, "fasta_seconds": t_fasta,
        "peak_device_bytes": peak, "launches": {k: v[0] for k, v in counts.items()},
        "plain_calls": {k: v[1] for k, v in counts.items()},
        "hits_checked": sum(len(h) for h in hits.values()), "q144_scores_equal": n_equal,
    })
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to check", file=sys.stderr)
        return 2
    try:
        from cudasw4_tpu_torch.ops import cuda_lib
    except ImportError as ex:
        print(f"chip_smoke: run from the repository root ({ex})", file=sys.stderr)
        return 2
    card = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    t0 = time.perf_counter()
    cached = cuda_lib.library_path().exists()
    cuda_lib.lib()
    emit({"phase": "device", "card": card, "sm_clock_max_mhz": clock_mhz,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "library_cached": cached,
          "build_and_load_seconds": time.perf_counter() - t0})
    phase_kernels(clock_mhz)
    phase_golden()
    kernels = phase_sprot(clock_mhz)
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
