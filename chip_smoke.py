#!/usr/bin/env python3
"""Drive the cudasw4_tpu_torch port on one NVIDIA GPU and check it.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing one JSON line with its seconds; any failure exits
non-zero:

1. device:  the card's name and power limit (nvidia-smi) and the packaged
   tuning config that applies to it, if any; then build: the CUDA kernel
   library from csrc/ with nvcc from an empty object directory, its units
   compiled in parallel (seconds, nproc, units, workers), every exported
   launcher present.
2. kernels: each kernel (cell, row, col with its carry, cell batch, col
   flat, col fused) against its plain PyTorch version on the card, exact
   equality of the integer scores, both alphabets; kernel, plain and
   bound times.  The row kernel on both of its routes (ROW_SHAPES: the
   cell group routine up to L = 768, each line with its (G, R), and the
   col wavefront past it, with a query past NQC rows in tile groups).  The col kernel also at its edges (COL_EDGES: one partial
   pass, a partial last pass over three chunks with the carry, nq_pad =
   8), scores and carried rows, and col flat on one pass of slots of 8,
   1000 and 3072 rows.  The col kernels take their tiles' subject lengths
   (ragged, with empty lanes) as the main path gives them, the carry
   compared inside the subjects' own passes; the edges and the unequal
   slots also run without lengths, comparing the whole carry.  The int16 modes of cell and col (col over two
   chunks with the int32 carry, and at its edges) against their plain
   versions and the exact
   scores under the SAT rule (``sw_cell.sat_match``), at the default SAT
   and at one that most subjects reach; every (G, R) instance of the cell
   kernels on one tile (CELL_LS: subjects of L, L - 1 and 1 residues,
   empty lanes; nq = 1, 8, 9, 464; int16 under the SAT rule), B4 on
   unequal slots with 0-row and 1-row ones (1, 3 and 14 slots), and B1
   int16 with a matrix that s16x2 lanes cannot hold; B4 int16 (its cell
   route and, at L = 896, col flat int16), B5 and B6 int16 on unequal
   slots, equal to the exact kernels' scores at the default SAT and under
   the SAT rule at a lowered one; the manual-staging kernel (B7, on the
   cell group routine fed from a shared-memory ring; int16 under the SAT
   rule at the default and a lowered SAT) and the pair kernel (B8, P = 2,
   4) against the cell kernel's plain version, up to the largest cell
   instance and past it (their col route), each timed beside the cell
   kernel in the same mode.
3. golden:  the port's makedb and align --tsv --top 10 on the golden
   fixtures, byte for byte against golden_top10.tsv and
   golden_top10_full.tsv.
4. sprot:   a Swiss-Prot-scale database (573,000 sequences, log-normal
   lengths, median 292, sigma 0.64, clipped to [11, 35000], ~205M
   residues, seed 42) through the port's makedb and align on the
   reference's 20 queries (benchmarks/allqueries.fasta, 144..5478 aa):
   the 14 of at most NQC residues run as one batch (cell batch, col flat
   on a 5-pass plan, row per slot), the 6 longer ones as singles.  Every
   reported hit is re-scored by the vectorised oracle, the tie order is
   checked, the launch counters of the align run show the path, and all
   573k scores of every batch slot are held against the single-query
   kernels' scores.  Then one scan_batch of the 14 with COL_FUSE_MIN_S =
   3 (its counters show the fused kernel) gives the same scores; the
   batch and the singles are timed on the same queries; device time by
   kernel kind per ladder query and for the batch; and the card's idle
   share over the 20-query scan from a torch.profiler trace, given only
   where the trace's kernels number the launch counters' (else null, with
   the kernels that differ; phase 8's traces too); every cell
   bucket with the 464-aa query in both state modes (its (G, R), ms,
   bound and share); the align's peak device memory, and the flat and
   fused batches' peaks above what is live before them.
5. state16: align --dpx on the 20 queries (singles in int16 state), TSV
   equal to the exact run's; again with SAT lowered to the median top
   score, so that real tiles flag and are re-scored; a planted 3,100-W
   subject (34,100 > SAT) on a small database, exact after the re-score
   of only its flagged tile; the 20 queries as singles in int16 and in
   int32 state, timed in turns.
6. long_query: the two longest queries joined (> QCAP = 8192 aa) against
   the Swiss-Prot-scale database, hits against the oracle, GCUPS.
7. routing: the engine's per-query-length routing (COL_SINGLE_MIN_ROWS,
   ``_single_kinds``) on the same database: each query's routed cell
   buckets at each window; the 20 queries as singles in exact and in
   int16 state with the window at the port's default (closed), at the JAX
   engine's 512 and at 8 (every one-pass query routes), in turns; every
   run writes phase 4's TSV byte for byte and launches B3 (B3 int16) in
   place of B1 (B1 int16) on exactly the routed buckets; GCUPS of each
   window and every threshold's total, the best one in each state.
8. stream: the same database streamed under --maxGpuMem 736M
   --maxBatchBytes 16M (phase_stream): makedb --prepackStream builds the
   tile store and its b32 sidecar; align on the 20 queries in one pass
   writes phase 4's TSV byte for byte, launches B1-B5, keeps its prefix
   within budget and its peak memory within --maxGpuMem and below the
   resident align's; so do the prefix off, raw and b21 chunks, --dpx
   and the fused col kernel (B6); all 573k streamed scores of two queries
   equal the resident engine's; streamed and resident timed in turns,
   the copy stream's and the link's GB/s, the unpack per chunk, the idle
   share, and a projection to a TrEMBL-sized database.
9. mesh: the database sharded over two shards (two cards where there
   are two, else both on one card, each on its own stream; phase_mesh):
   resident, the 20 queries through scan_many with align's TSV writer,
   byte for byte phase 4's TSV, its counters B1-B5, and B6 from the batch
   with COL_FUSE_MIN_S = 3; int16 state, and again at a lowered SAT with
   tiles flagged on both shards (the mesh re-score); the 10,625-aa
   query; mesh against single device in turns, each shard's device time
   alone, the merge's time, peak memory; streamed on the mesh under a
   per-shard budget (a third or more of the padded bytes stream), the
   TSV again, each card's peak within its shards' budgets, all 573k
   scores of the 464-aa query against the resident engine's; then
   tools/run_multihost.py as two processes on the mesh over gloo and as
   one under NCCL at world size 1, every process printing phase 4's hits.
10. tools: dmabench and pairbench at their defaults, every line OK; the
   engine tools: bigsingle at T = 16 (B1 against B3 on the same cell
   tiles, both states, every line OK), sweepdiag at L = 1024 on 200,000
   sequences (per-query GCUPS), tremblbench at --scale 20 (1M sprot-like
   sequences streamed under a budget of 4 GiB / 20, its hits equal to a
   resident engine's on the same database).
11. colstate16: the ported tools/colstate16.py in a fresh process at
   T = 16, reps 3: B3 and B5 in int32 and int16 state at L = 1024 and
   2048 (GCUPS of each mode), every line OK (the modes agree under the SAT
   rule); each line's int16 scores equal the plain version's on the same
   inputs (the first tile; every tile of the L = 1024, 2 x 1024 flat line,
   timed).  Its counters are B5 int16's launches, and that flat line's
   call gives B5 int16's kernels-line figures.
12. warmup: fresh processes search phase 4's database for the 144-aa and
   then the 464-aa query, each alone, with warmup() and without (each
   query's seconds, the warmup's seconds and launches, the first batch's
   extra time over its second) and one streamed under phase stream's
   budget; the three write the same TSV.
13. tuning: gridsearch at its defaults with the (NQC, LC) sweep, the
   config it emits for this card; phase 4's database packed under the
   defaults and under the config (plans by kind), the 20 queries timed in
   turns (default, tuned, tuned, default) in exact and in int16 state,
   the TSV under the config phase 4's byte for byte.
14. native: the native IO library loaded; makedb of phase 4's FASTA with
   and without it, byte for byte equal, pack_db both ways with equal
   tiles, seconds for each; modifydb verify on the database.
15. profile: align --profile on two queries; the trace names the batch's
   kernels and the engine's spans.
16. bench: the benchmark entry points.  python -m cudasw4_tpu_torch.bench
   (bench.py's peak protocol on the port) as a child process at 100,000
   sequences and one rep, in sweep and in peak mode: exactly one stdout
   line with bench.py's keys and metric and a value > 0, six ``# L=``
   lines in sweep mode, every config resident, the child's launch
   counters on its path; the sweep's results, which num_top=0 hides: at
   each sweep L, 8,192 copies of the pseudo subject, every hit of the 20
   queries its oracle score on ids 0-9; runpeakbenchmark.sh's command for
   L = 1024 on the port's align (--top 0 --verbose --uploadFull
   --pseudodb 100000 1024), its Total time line; tools.dbbench at 200,000
   sequences, 2 reps, its BEST line and every hit against the oracle.
17. kernels line: per kernel, its launches on its path (align for the
   exact kernels but B6, the fused scan_batch for B6, align --dpx for the int16 modes of B1 and B3,
   colstate16 for B5 int16, the tools for the exact manual and pair
   kernels; each path's counters are reset just before it and read just
   after; B4, B6 and B7 int16, which no path reaches, show 0; each row's
   "path" names its path, null for these three), its
   launches on the streamed align
   (``stream_launches``, B6 from the fused streamed pass) and on the mesh
   (``mesh_launches``: phase mesh's resident run, B6 its fused batch,
   the int16 modes of B1 and B3 its int16 run; 0 for the tool kernels
   and the batch kernels' int16 modes), its launches in phase bench's
   sweep (``bench_launches``), and its time,
   bound and plain time at its
   main-path shape: the largest bucket of its kind, with the 464-aa query
   for the single-query kernels (and the manual and pair kernels, B7
   int16 on B1 int16's inputs), the
   batch of 14 for the cell batch, and the widest plan pass for the col
   kernels; B5 int16's is its colstate16 line (its figures at the align
   shape under "align_shape").

Bounds and per-kernel GCUPS count the DP cells the data needs: real query
rows times real subject residues; int16 state's bound counts two cells a
32-bit lane operation (the packed s16x2 forms).  The kernels also sweep
the padding after each subject (its matrix row is all negative, so it
changes no score); each line gives the padded cell count beside the real
one.

Then the nvidia-smi line and, last, the contract line
{"ok": true, "device": {...}}.  Needs CUDA: without it, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
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
#: int32 operations per DP cell with the DPX instructions, as the col
#: kernel's SASS spends them: E and F (one VIADDMNMX each), H (the diagonal
#: add fused into VIADDMNMX.RELU with E, then VIMNMX.RELU with F), H + gop
#: (shared by the next column's E and the next row's F), and the running
#: max over two cells in one VIMNMX3, half an operation a cell.
OPS_PER_CELL = 5.5
#: DP cells one 32-bit lane operation can update, by the lanes a kernel
#: runs: the packed s16x2 forms (vadd2/vmax2 and the DPX s16x2
#: instructions) update two cells an operation, as int16 state and the
#: exact cell kernels proven to fit them do.
CELLS_PER_LANE_OP = {"int32": 1, "s16x2": 2}

#: The Swiss-Prot length model (benchmarks/make_synthetic_db.py, "sprot").
SPROT_NUM, SPROT_MEDIAN, SPROT_SIGMA = 573_000, 292.0, 0.64
#: The per-bucket breakdown's queries: these lengths of the query set.
QUERY_LADDER = (144, 464, 1000, 3005, 5478)
#: Each kernels-line row names the path its launches come from: "align",
#: "align --dpx", the fused scan_batch (FUSED_PATH), a tool, or None where
#: no entry point reaches the kernel.  The mesh runs the first three.
FUSED_PATH = "scan_batch (fused)"
MESH_PATHS = ("align", "align --dpx", FUSED_PATH)
#: The planted int16 overflow: a subject of PLANTED_W W's against the same
#: query scores 11 x 3,100 = 34,100 on blosum62, above SAT = 32,000.
PLANTED_W = 3100
AAS = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", dtype=np.uint8)

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
QUERY_SET = os.path.join(REPO, "benchmarks", "allqueries.fasta")


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


def cuda_ms(fn, reps: int = 3, warmup: bool = True) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events, one warm-up
    call unless ``warmup`` is false)."""
    if warmup:
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def timed(fn):
    """(result, milliseconds) of one call of ``fn`` on the card (CUDA
    events around it, no warm-up)."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def bound(cells: float, nbytes: float, clock_mhz: float, lanes: str = "int32"):
    """Least time the card could take: the larger of bytes over the memory
    rate and the cells' operations over the lane rate, at two cells an
    operation in s16x2 ``lanes``.  Returns (ms, by)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    lane_ops = cells * OPS_PER_CELL / CELLS_PER_LANE_OP[lanes]
    t_ops = lane_ops / (INT32_LANES * clock_mhz * 1e6) * 1e3
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


def col_lengths(t, pad, empty=0):
    """The subject lengths (``sw_col.ColLengths``) of ``random_tiles``'s
    col tiles on the card, as the main path hands them to every col
    launch; ``empty`` lanes at the end of the last tile are first emptied
    in place (padding lanes, length 0)."""
    from cudasw4_tpu_torch.ops import sw_col

    x = t.view(t.shape[0], t.shape[1], -1)
    if empty:
        x[-1, :, -empty:] = pad
    lens = (x != pad).sum(dim=1, dtype=torch.int32)
    return sw_col.ColLengths.place(lens.cpu().numpy(), t.device)


def own_passes(t, lengths):
    """Mask shaped as the col tiles ``t`` of the columns inside each
    subject's own passes: where a launch given ``lengths`` emits a
    specified carry.  Every column without lengths."""
    from cudasw4_tpu_torch.ops import sw_col

    if lengths is None:
        return torch.ones(t.shape, dtype=torch.bool, device=t.device)
    P = sw_col.col_pass(t.device)
    ends = (lengths.dev.long() + P - 1) // P * P
    cols = torch.arange(t.shape[1], device=t.device)
    return (cols[None, :, None] < ends[:, None, :]).reshape(t.shape)


def cell_counts(shape, nrows, real_rows, real_chars):
    """(real, padded) DP cells of one kernel call: real query rows x real
    subject residues, and every query row run x every tile position."""
    return real_rows * real_chars, nrows * int(np.prod(shape))


def query_block(rng, nq, cap, A, pad):
    q = np.full(cap, pad, np.int32)
    q[:nq] = rng.integers(0, A - 1, size=nq)
    return torch.as_tensor(q).cuda()


#: B3's edge cases in phase 2, beside the two 3072-row chunks at L=1024:
#: (tiles shape, real rows of each query chunk).  The col kernel's pass is
#: 512 columns: L=128 is one partial pass; L=1152 is two full passes and a
#: partial one, over three chunks with the carry; 8 rows is the least
#: nq_pad.
COL_EDGES = (
    ((1, 128, 32, 128), (13,)),
    ((1, 1152, 32, 128), (40, 3, 21)),
    ((2, 640, 32, 128), (8, 5)),
)


def col_chunks(chunks, cfg):
    """Query chunks (host codes) as the col kernel takes them: [(query on
    the card, params)], each padded to NQC and its rows to a multiple of 8."""
    from cudasw4_tpu_torch.ops import sw_col

    out = []
    for c in chunks:
        qp, nq_pad = sw_col.pad_query_chunk(c, pad=cfg.pad_code)
        out.append((torch.as_tensor(qp).cuda(), (nq_pad, cfg.gop, cfg.gex, 0)))
    return out


def col_chain(name, t, chunks, m, sat=None, ref=None, lengths=None):
    """B3 and its plain version over the query ``chunks`` with the carry
    between them, the kernel given the tiles' ``lengths`` (or None).  Exact
    state (``sat`` None): scores equal at every chunk, and both carried
    rows at every column inside the subjects' own passes (``own_passes``:
    every column without lengths); returns the runs [(kernel scores, plain
    scores, the plain carry into the chunk or None, ms of the one plain
    call)].  int16 state at ``sat``: the scores so far meet the SAT rule
    against the plain int16 run's and the exact run's (``ref``, the exact
    chain's runs), and the carried rows equal the plain int16 run's, inside
    the own passes, on every subject whose exact score so far is below
    sat; returns the subjects at or above sat."""
    from cudasw4_tpu_torch.ops import sw_cell, sw_col

    default = sw_cell.SAT
    sw_cell.SAT = sat or default
    own = own_passes(t, lengths)
    try:
        st = st_w = None
        runs, best = [], None
        for k, (q, p) in enumerate(chunks):
            emit = k + 1 < len(chunks)
            kw = {"emit_state": emit, "exact": sat is None}
            got = sw_col.score_bucket_col(t, q, m, p, state_in=st, take_init=st is not None,
                                          lengths=lengths, **kw)
            want, pms = timed(lambda: sw_col.score_bucket_col_plain(t, q, m, p, state_in=st_w, **kw))
            st_in = st_w
            if emit:
                (got, st), (want, st_w) = got, want
            runs.append((got, want, st_in, pms))
            if sat is None:
                check(torch.equal(got, want), f"{name} chunk {k}: kernel != plain")
                check(not emit or all(torch.equal(a[own], b[own]) for a, b in zip(st, st_w)),
                      f"{name} chunk {k}: carried H/F rows != plain")
                continue
            step = (got, want, ref[k][1])
            best = step if best is None else tuple(map(torch.maximum, best, step))
            check_sat_rule(f"{name} int16 chunk {k}", best[0], best[1], sat)
            check_sat_rule(f"{name} int16 chunk {k} vs exact", best[0], best[2], sat)
            if emit:
                live = (best[2] < sat).reshape(t.shape[0], 1, 32, 128).expand(t.shape) & own
                check(all(a.dtype == torch.int32 and torch.equal(a[live], b[live])
                          for a, b in zip(st, st_w)),
                      f"{name} int16 chunk {k}: carried rows != plain below SAT={sat}")
    finally:
        sw_cell.SAT = default
    return runs if sat is None else int((best[2] >= sat).sum())


# --------------------------------------------------------------- phase 2

def phase_kernels(clock_mhz):
    from cudasw4_tpu_torch import make_scoring_config
    from cudasw4_tpu_torch.ops import col_flat_plan, cuda_lib, sw_cell, sw_col, sw_row
    from cudasw4_tpu_torch.ops.sw_torch import sweep_tiles_torch

    t_phase = time.perf_counter()
    rng = np.random.default_rng(7)
    rows = []

    def record(name, mat, shape, nq, real_nq, real_chars, got, want, ms, plain_ms,
               extra_bytes=0, slots=1, **extra):
        check(torch.equal(got, want), f"{name} {mat} {shape}: kernel != plain")
        real, padded = cell_counts(shape, nq, real_nq, real_chars)
        out_bytes = slots * shape[0] * int(np.prod(shape[2:])) * 4
        b_ms, by = bound(real, int(np.prod(shape)) + 4 * nq + out_bytes + extra_bytes, clock_mhz)
        rows.append({
            "check": name, "mat": mat, "shape": list(shape), "nq": nq, "equal": True,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "cells_real": real, "cells_padded": padded,
            "gcups_real": real / ms / 1e6, "gcups_padded": padded / ms / 1e6, **extra,
        })

    for mat in ("blosum62", "blosum62_full"):
        cfg = make_scoring_config(mat)
        A, pad = cfg.alphabet_size, cfg.pad_code
        m = cuda_lib.device_matrix(cfg.matrix, "cuda")
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
        for shape in ROW_SHAPES[: None if mat == "blosum62" else 3]:
            t, real_chars = random_tiles(rng, shape, A, pad)
            q = query_block(rng, 464, sw_cell.QCAP, A, pad)
            p = (464, cfg.gop, cfg.gex, 464)
            got = sw_row.score_bucket_row(t, q, m, p)
            want = sw_row.score_bucket_row_plain(t, q, m, p)
            ms = cuda_ms(lambda: sw_row.score_bucket_row(t, q, m, p))
            pms = cuda_ms(lambda: sw_row.score_bucket_row_plain(t, q, m, p), reps=1)
            route, cell, groups, pool = sw_row.row_route(*shape, 464)
            record("B2 row", mat, shape, 464, 464, real_chars, got, want, ms, pms,
                   route=route, cell_shape=cell and list(cell), pool_bytes=pool)
        # B2's col route with a query past NQC rows, in one-tile groups.
        shape = (3, 1100, 128)
        t, _ = random_tiles(rng, shape, A, pad)
        nq = sw_col.NQC + 28
        q = query_block(rng, nq, nq, A, pad)
        p = (nq, cfg.gop, cfg.gex, nq)
        before = sw_row.score_bucket_row.launches
        got = sw_row.score_bucket_row(t, q, m, p, temp_bytes=1)
        check(sw_row.score_bucket_row.launches == before + 3, "B2 one-tile groups: launches != 3")
        check(torch.equal(got, sw_row.score_bucket_row_plain(t, q, m, p)),
              f"B2 col route {mat} nq={nq}, one-tile groups: kernel != plain")
        rows.append({"check": "B2 row, col route, one-tile groups", "mat": mat,
                     "shape": list(shape), "nq": nq, "launches": 3, "equal": True})

        # B3: a 5478-aa query over L=1024 col tiles with ragged lengths
        # and 64 empty lanes, given their lengths as the main path gives
        # them: two NQC chunks with the H/F carry, each chunk and its
        # carried state (inside the subjects' own passes) against the
        # plain version (its one call timed; the kernel also timed without
        # lengths); then the whole query through the any-length function
        # with one-tile groups against one plain sweep.
        shape = (2, 1024, 32, 128)
        t, _ = random_tiles(rng, shape, A, pad)
        lengths = col_lengths(t, pad, empty=64)
        real_chars = int(lengths.dev.sum())
        codes = rng.integers(0, A - 1, size=5478).astype(np.int8)
        chunks = [codes[:sw_col.NQC], codes[sw_col.NQC:]]
        qs = col_chunks(chunks, cfg)
        runs = col_chain(f"B3 {mat}", t, qs, m, lengths=lengths)
        for k, (chunk, (q, p), (got, want, st_w, pms)) in enumerate(zip(chunks, qs, runs)):
            def b3(lens):
                return sw_col.score_bucket_col(t, q, m, p, state_in=st_w,
                                               take_init=st_w is not None, emit_state=k == 0,
                                               lengths=lens)
            ms, ms0 = cuda_ms(lambda: b3(lengths)), cuda_ms(lambda: b3(None))
            io_bytes = 8 * int(np.prod(shape))  # carry out (chunk 0) or in (chunk 1)
            record(f"B3 col chunk {k}", mat, shape, p[0], len(chunk), real_chars,
                   got, want, ms, pms, io_bytes, without_lengths_ms=ms0)
        got = sw_col.score_bucket_col_any_query(t, codes, m, cfg.gop, cfg.gex, pad=pad,
                                                temp_bytes=1, lengths=lengths)
        best, _, _ = sweep_tiles_torch(t.reshape(2, 1024, 4096), codes.tolist(),
                                       m.view(A, A), cfg.gop, cfg.gex)
        check(torch.equal(got, best.float()), f"B3 any-query one-tile groups {mat}: != plain")
        rows.append({"check": "B3 col any-query, one-tile groups", "mat": mat,
                     "shape": list(shape), "nq": 5478, "equal": True})
        # B3's edges: one partial pass, a partial last pass with the carry
        # over three chunks, and chunks of nq_pad = 8; on ragged lanes with
        # 64 empty ones, without lengths (the whole carry) and with them.
        for eshape, lens in COL_EDGES:
            t, _ = random_tiles(rng, eshape, A, pad)
            ragged = col_lengths(t, pad, empty=64)
            qs = col_chunks([rng.integers(0, A - 1, size=n).astype(np.int8) for n in lens], cfg)
            for lengths in (None, ragged):
                col_chain(f"B3 {mat} {eshape} rows {lens} lengths {lengths is not None}", t, qs,
                          m, lengths=lengths)
            rows.append({"check": "B3 col edge, carried rows", "mat": mat, "shape": list(eshape),
                         "chunk_rows": [p[0] for _, p in qs], "lengths": [False, True],
                         "equal": True})

        # B4: four slots (one empty, lengths not multiples of 8) over cell
        # tiles.  B5 and B6: three slots on their col_flat_plan pass over
        # col tiles, padded rows walked.
        shape = (4, 256, 32, 128)
        t, real_chars = random_tiles(rng, shape, A, pad)
        lens = [464, 0, 37, 201]
        qs = torch.stack([query_block(rng, n, 512, A, pad) for n in lens])
        p = (0, cfg.gop, cfg.gex, 0, *lens)
        got = sw_cell.score_bucket_cell_batch(t, qs, m, p)
        pms = cuda_ms(lambda: sw_cell.score_bucket_cell_batch_plain(t, qs, m, p), reps=1, warmup=False)
        want = sw_cell.score_bucket_cell_batch_plain(t, qs, m, p)
        ms = cuda_ms(lambda: sw_cell.score_bucket_cell_batch(t, qs, m, p))
        record("B4 cell batch", mat, shape, sum(lens), sum(lens), real_chars, got, want, ms, pms,
               slots=len(lens))
        # B5 and B6 take the tiles' lengths (64 empty lanes), each also
        # timed without.
        shape = (2, 1024, 32, 128)
        t, _ = random_tiles(rng, shape, A, pad)
        lengths = col_lengths(t, pad, empty=64)
        real_chars = int(lengths.dev.sum())
        lens = [300, 1000, 77]
        pads = [sw_col.padded_rows(n) for n in lens]
        (plan,) = col_flat_plan(pads)
        offs = tuple(o for _, o in sorted(plan))
        qs = torch.stack([query_block(rng, n, sw_col.NQC, A, pad) for n in lens])
        p = (0, cfg.gop, cfg.gex, 0, *pads)
        pms = cuda_ms(lambda: sw_col.score_bucket_col_flat_plain(t, qs, m, p), reps=1, warmup=False)
        want = sw_col.score_bucket_col_flat_plain(t, qs, m, p)
        for name, fn in (
            ("B5 col flat", lambda lens: sw_col.score_bucket_col_flat(t, qs, m, p, offs,
                                                                      lengths=lens)),
            ("B6 col fused", lambda lens: sw_col.score_bucket_col_flat_fused(t, qs, m, p,
                                                                             lengths=lens)),
        ):
            check(torch.equal(fn(None), want), f"{name} {mat} {shape} without lengths: != plain")
            ms, ms0 = cuda_ms(lambda: fn(lengths)), cuda_ms(lambda: fn(None))
            record(name, mat, shape, sum(pads), sum(lens), real_chars, fn(lengths), want, ms,
                   pms, slots=len(lens), without_lengths_ms=ms0)
        # B5 on one pass of unequal slots, 8 to 3072 rows, in a pool of
        # their reservations, over a partial last subject pass.
        shape = (1, 1152, 32, 128)
        t, real_chars = random_tiles(rng, shape, A, pad)
        lengths = col_lengths(t, pad, empty=64)
        lens = [8, 1000, 3072]
        rtot = sum(-(-n // sw_col.FLAT_QUANT) * sw_col.FLAT_QUANT for n in lens)
        (plan,) = col_flat_plan(lens, rtot=rtot)
        offs = tuple(o for _, o in sorted(plan))
        qs = torch.stack([query_block(rng, n, sw_col.NQC, A, pad) for n in lens])
        p = (0, cfg.gop, cfg.gex, 0, *lens)
        want = sw_col.score_bucket_col_flat_plain(t, qs, m, p)
        for lens_ in (None, lengths):
            got = sw_col.score_bucket_col_flat(t, qs, m, p, offs, rtot=rtot, lengths=lens_)
            check(torch.equal(got, want), f"B5 col flat {mat} slots {lens} lengths "
                                          f"{lens_ is not None}: kernel != plain")
        rows.append({"check": "B5 col flat, unequal slots", "mat": mat, "shape": list(shape),
                     "slot_rows": lens, "pool_offsets": list(offs), "rtot": rtot,
                     "lengths": [False, True], "equal": True})
        phase_kernels_state16(mat, cfg, m, rng, rows)
    phase_kernels_cell(rng, rows)
    phase_kernels_tools(rng, rows)
    for r in rows:
        emit({"phase": "kernels", **r})
    emit({"phase": "kernels", "seconds": time.perf_counter() - t_phase})


#: Phase 2's row buckets: the Swiss-Prot-scale database's largest (L = 48),
#: cell-route ones at (8, 6) and (16, 32), and col-route ones past the
#: largest cell instance (L = 784, 256 lanes; L = 2304, full passes); the
#: full-blosum alphabet takes the first three.
ROW_SHAPES = ((11, 48, 128), (16, 512, 128), (3, 784, 256), (4, 2304, 128))
#: Phase 2's cell lengths: every multiple of 16 up to CELL_MAX_L = 768
#: (the 16-step edges, which hold the default ladder's cell lengths),
#: which reach every (G, R) instance (G x R = L, or 16 more past 576); 37
#: and 300 (G x R > L); and 896, past the largest instance (the col
#: wavefront's passes).
CELL_LS = (*range(16, 769, 16), 37, 300, 896)
#: B4's slot cases in phase 2: one slot, three with a 0-row and a 1-row
#: one, fourteen unequal ones; at these lengths.
CELL_BATCH_SLOTS = ((37,), (0, 1, 200), (144, 0, 1, 9, 33, 64, 8, 100, 7, 1, 250, 16, 71, 0))
CELL_BATCH_LS = (64, 256, 296, 640, 768, 896)


def edge_lanes(t, pad, rng):
    """In place on cell tiles on the card: lanes 0-5 of tile 0 hold
    subjects of L, L - 1, 1, L, 1 and L - 1 residues (both halves of the
    int16 kernel's subject pairs); the last 100 lanes are empty."""
    x = t.view(t.shape[0], t.shape[1], 4096)
    L = x.shape[1]
    for lane, n in enumerate((L, L - 1, 1, L, 1, L - 1)):
        x[0, :, lane] = torch.as_tensor(rng.integers(0, pad, size=L).astype(np.int8)).cuda()
        x[0, n:, lane] = pad
    x[-1, :, -100:] = pad


def phase_kernels_cell(rng, rows):
    """Every (G, R) instance of the cell kernels against the plain version
    on one tile (CELL_LS): B1 at nq = 1, 8, 9 and 464, exact; B1 int16 at
    464 rows under the SAT rule against the plain int16 and the exact
    scores, at the default SAT and at one that most subjects reach; the
    alphabet alternates by length, and the classic one takes the default
    SAT and 464 rows at every length.  Then B4 on unequal slots
    (CELL_BATCH_SLOTS x CELL_BATCH_LS, both alphabets), and B1 int16 with
    a matrix whose scores no s16x2 lane could hold (the int32 routine)."""
    from cudasw4_tpu_torch import make_scoring_config
    from cudasw4_tpu_torch.ops import cuda_lib, sw_cell

    names = ("blosum62", "blosum62_full")
    cfgs = [make_scoring_config(n) for n in names]
    mats = [cuda_lib.device_matrix(c.matrix, "cuda") for c in cfgs]
    default = sw_cell.SAT
    shapes, saturated = [], 0
    for k, L in enumerate(CELL_LS):
        for a in sorted({0, k % 2}):
            cfg, m = cfgs[a], mats[a]
            A, pad = cfg.alphabet_size, cfg.pad_code
            t, _ = random_tiles(rng, (1, L, 32, 128), A, pad)
            edge_lanes(t, pad, rng)
            q = query_block(rng, 464, 512, A, pad)
            for nq in (1, 8, 9, 464) if a == k % 2 else (464,):
                p = (nq, cfg.gop, cfg.gex, -(-nq // 8) * 8)
                want = sw_cell.score_bucket_cell_plain(t, q, m, p)
                check(torch.equal(sw_cell.score_bucket_cell(t, q, m, p), want),
                      f"B1 L={L} {names[a]} nq={nq}: kernel != plain")
            for sat in (default, lowered_sat(want)) if a == k % 2 else (default,):
                sw_cell.SAT = sat
                try:
                    got = sw_cell.score_bucket_cell(t, q, m, p, exact=False)
                    check_sat_rule(f"B1 int16 L={L} {names[a]}", got,
                                   sw_cell.score_bucket_cell_plain(t, q, m, p, exact=False), sat)
                    check_sat_rule(f"B1 int16 L={L} {names[a]} vs exact", got, want, sat)
                finally:
                    sw_cell.SAT = default
                saturated += int((want >= sat).sum())
        shapes.append([L, *(sw_cell.cell_shape(L) or ("col", "passes"))])
    rows.append({"check": "B1 cell and B1 int16, every (G, R) instance", "shapes": shapes,
                 "nq": [1, 8, 9, 464], "equal": True, "sat_rule": True,
                 "saturated_at_lowered_sat": saturated})
    for a, cfg in enumerate(cfgs):
        A, pad = cfg.alphabet_size, cfg.pad_code
        for L in CELL_BATCH_LS:
            t, _ = random_tiles(rng, (2, L, 32, 128), A, pad)
            edge_lanes(t, pad, rng)
            for lens in CELL_BATCH_SLOTS:
                qs = torch.stack([query_block(rng, n, 256, A, pad) for n in lens])
                p = (0, cfg.gop, cfg.gex, 0, *lens)
                got = sw_cell.score_bucket_cell_batch(t, qs, mats[a], p)
                check(torch.equal(got, sw_cell.score_bucket_cell_batch_plain(t, qs, mats[a], p)),
                      f"B4 L={L} {names[a]} slots {lens}: kernel != plain")
        rows.append({"check": "B4 cell batch, unequal slots", "mat": names[a],
                     "L": list(CELL_BATCH_LS), "slot_rows": [list(x) for x in CELL_BATCH_SLOTS],
                     "equal": True})
    cfg = cfgs[0]
    A, pad = cfg.alphabet_size, cfg.pad_code
    t, _ = random_tiles(rng, (1, 64, 32, 128), A, pad)
    q = query_block(rng, 9, 64, A, pad)
    t.view(64, 4096)[:9, 0] = q[:9].to(torch.int8)  # subject 0 holds the query
    m = mats[0] * 1000
    p = (9, cfg.gop, cfg.gex, 16)
    want = sw_cell.score_bucket_cell_plain(t, q, m, p)
    check(int(want.max()) > 32767, "the scaled matrix does not pass the int16 range")
    got = sw_cell.score_bucket_cell(t, q, m, p, exact=False)
    check_sat_rule("B1 int16 with an unproven fit", got, want, default)
    check_sat_rule("B1 int16 with an unproven fit, vs plain int16", got,
                   sw_cell.score_bucket_cell_plain(t, q, m, p, exact=False), default)
    rows.append({"check": "B1 int16, unproven fit (blosum62 x 1000): the int32 routine",
                 "max_score": int(want.max()), "sat_rule": True,
                 "equal_to_exact": bool(torch.equal(got, want))})


def lowered_sat(scores) -> int:
    """A SAT that most subjects reach: the 25th percentile of the positive
    exact scores."""
    pos = scores[scores > 0].float()
    return max(1, int(torch.quantile(pos[: 1 << 24], 0.25)))


def check_sat_rule(name, got, want, sat):
    from cudasw4_tpu_torch.ops import sw_cell

    check(bool(sw_cell.sat_match(got, want, sat).all()), f"{name}: breaks the SAT rule at SAT={sat}")


def phase_kernels_state16(mat, cfg, m, rng, rows):
    """B1 and B3 in int16 mode against their plain versions (int16 and
    exact) under the SAT rule, at the default SAT and at one that most
    subjects reach; B3 over two chunks with the int32 carry and at its
    edge shapes (COL_EDGES), the carried state equal on every subject
    below SAT."""
    from cudasw4_tpu_torch.ops import sw_cell, sw_col

    A, pad = cfg.alphabet_size, cfg.pad_code
    default = sw_cell.SAT
    shape = (8, 256, 32, 128)
    t, real_chars = random_tiles(rng, shape, A, pad)
    q = query_block(rng, 464, sw_cell.QCAP, A, pad)
    p = (464, cfg.gop, cfg.gex, 464)
    exact = sw_cell.score_bucket_cell_plain(t, q, m, p)
    for sat in (default, lowered_sat(exact)):
        sw_cell.SAT = sat
        try:
            got = sw_cell.score_bucket_cell(t, q, m, p, exact=False)
            want = sw_cell.score_bucket_cell_plain(t, q, m, p, exact=False)
            check_sat_rule(f"B1 int16 {mat}", got, want, sat)
            check_sat_rule(f"B1 int16 {mat} vs exact", got, exact, sat)
            ms = cuda_ms(lambda: sw_cell.score_bucket_cell(t, q, m, p, exact=False))
        finally:
            sw_cell.SAT = default
        rows.append({"check": "B1 cell int16", "mat": mat, "shape": list(shape), "nq": 464,
                     "sat": sat, "sat_rule": True, "saturated": int((exact >= sat).sum()),
                     "ms": ms})

    shape = (2, 1024, 32, 128)
    t, real_chars = random_tiles(rng, shape, A, pad)
    lengths = col_lengths(t, pad, empty=64)
    codes = rng.integers(0, A - 1, size=5478).astype(np.int8)
    qs = col_chunks([codes[:sw_col.NQC], codes[sw_col.NQC:]], cfg)
    ref = col_chain(f"B3 {mat}", t, qs, m, lengths=lengths)
    st = ref[1][2]
    for sat in (default, lowered_sat(ref[0][1])):
        saturated = col_chain(f"B3 {mat}", t, qs, m, sat, ref, lengths)
        sw_cell.SAT = sat
        try:
            ms = cuda_ms(lambda: sw_col.score_bucket_col(t, qs[1][0], m, qs[1][1], state_in=st,
                                                         take_init=True, exact=False,
                                                         lengths=lengths))
        finally:
            sw_cell.SAT = default
        rows.append({"check": "B3 col int16, two chunks with the carry", "mat": mat,
                     "shape": list(shape), "nq": 5478, "sat": sat, "sat_rule": True,
                     "saturated": saturated, "ms_chunk1": ms})
    for eshape, lens in COL_EDGES:
        t, _ = random_tiles(rng, eshape, A, pad)
        ragged = col_lengths(t, pad, empty=64)
        qs = col_chunks([rng.integers(0, A - 1, size=n).astype(np.int8) for n in lens], cfg)
        for lengths in (None, ragged):
            name = f"B3 {mat} {eshape} rows {lens} lengths {lengths is not None}"
            ref = col_chain(name, t, qs, m, lengths=lengths)
            for sat in (default, lowered_sat(ref[0][1])):
                rows.append({"check": "B3 col int16 edge", "mat": mat, "shape": list(eshape),
                             "chunk_rows": [p[0] for _, p in qs], "sat": sat, "sat_rule": True,
                             "lengths": lengths is not None,
                             "saturated": col_chain(name, t, qs, m, sat, ref, lengths)})

    # B4 int16 (its cell route and, past the largest instance, col flat
    # int16), B5 and B6 int16 on unequal slots (one empty), over a partial
    # last col pass.
    from cudasw4_tpu_torch.ops import col_flat_plan

    for shape, lens in (((4, 256, 32, 128), [464, 0, 37, 201]), ((2, 896, 32, 128), [300, 0, 1, 77])):
        t, _ = random_tiles(rng, shape, A, pad)
        qs = torch.stack([query_block(rng, n, 512, A, pad) for n in lens])
        p = (0, cfg.gop, cfg.gex, 0, *lens)
        batch_state16(rows, mat, shape, lens, {
            "B4 cell batch int16": lambda **kw: sw_cell.score_bucket_cell_batch(t, qs, m, p, **kw),
        }, lambda **kw: sw_cell.score_bucket_cell_batch_plain(t, qs, m, p, **kw))
    shape = (1, 1152, 32, 128)
    t, _ = random_tiles(rng, shape, A, pad)
    lengths = col_lengths(t, pad, empty=64)
    lens = [300, 1000, 0, 77]
    pads = [n and sw_col.padded_rows(n) for n in lens]
    (plan,) = col_flat_plan(pads)
    offs = tuple(o for _, o in sorted(plan))
    qs = torch.stack([query_block(rng, n, sw_col.NQC, A, pad) for n in lens])
    p = (0, cfg.gop, cfg.gex, 0, *pads)
    batch_state16(rows, mat, shape, pads, {
        "B5 col flat int16": lambda **kw: sw_col.score_bucket_col_flat(t, qs, m, p, offs,
                                                                       lengths=lengths, **kw),
        "B6 col fused int16": lambda **kw: sw_col.score_bucket_col_flat_fused(t, qs, m, p,
                                                                             lengths=lengths,
                                                                             **kw),
    }, lambda **kw: sw_col.score_bucket_col_flat_plain(t, qs, m, p, **kw))


def batch_state16(rows, mat, shape, slot_rows, kernels, plain):
    """Batch kernels' int16 modes (``kernels``: name -> wrapper call; each
    run with ``exact=False``) against their exact kernel's scores and
    their shared plain version: at the default SAT equal to the exact
    kernel's scores and to the plain int16 version's; at a SAT that most
    subjects reach, under the SAT rule against the plain int16 and the
    exact scores."""
    from cudasw4_tpu_torch.ops import sw_cell

    want_exact = plain()
    exact = {}
    for name, fn in kernels.items():
        exact[name] = fn()
        check(torch.equal(exact[name], want_exact), f"{name} {mat} {shape}: exact kernel != plain")
    default = sw_cell.SAT
    for sat in (default, lowered_sat(want_exact)):
        sw_cell.SAT = sat
        try:
            want = plain(exact=False)
            got = {name: fn(exact=False) for name, fn in kernels.items()}
        finally:
            sw_cell.SAT = default
        for name, g in got.items():
            if sat == default:
                check(torch.equal(g, exact[name]) and torch.equal(g, want),
                      f"{name} {mat} {shape} at the default SAT: != the exact scores")
            check_sat_rule(f"{name} {mat} {shape}", g, want, sat)
            check_sat_rule(f"{name} {mat} {shape} vs exact", g, want_exact, sat)
            rows.append({"check": name, "mat": mat, "shape": list(shape),
                         "slot_rows": list(slot_rows), "sat": sat, "sat_rule": True,
                         "saturated": int((want_exact >= sat).sum())})


def phase_kernels_tools(rng, rows):
    """B7 (both modes) and B8 (P = 2, 4) against B1's plain version, at the
    cell shapes above, at the top Swiss-Prot-scale cell bucket's
    [12, 640, 32, 128] x 464 and past the largest cell instance (their col
    route), each timed beside B1 in the same mode on the same inputs; B7
    int16 under the SAT rule at the default SAT and at one that most
    subjects reach."""
    from cudasw4_tpu_torch import make_scoring_config
    from cudasw4_tpu_torch.ops import cuda_lib, sw_cell
    from cudasw4_tpu_torch.tools.pairbench import score_pair

    cfg = make_scoring_config("blosum62")
    A, pad = cfg.alphabet_size, cfg.pad_code
    m = cuda_lib.device_matrix(cfg.matrix, "cuda")
    default = sw_cell.SAT
    for shape in ((8, 256, 32, 128), (4, 768, 32, 128), (12, 640, 32, 128), (4, 896, 32, 128)):
        t, real_chars = random_tiles(rng, shape, A, pad)
        q = query_block(rng, 464, sw_cell.QCAP, A, pad)
        p = (464, cfg.gop, cfg.gex, 464)
        want = sw_cell.score_bucket_cell_plain(t, q, m, p)
        b1_ms = {exact: cuda_ms(lambda exact=exact: sw_cell.score_bucket_cell(
            t, q, m, p, exact=exact)) for exact in (True, False)}
        for exact in (True, False):
            def fn(exact=exact):
                return sw_cell.score_bucket_cell_manual(t, q, m, p, exact=exact)
            name = f"B7 manual {'int32' if exact else 'int16'}"
            sats = [None] if exact else [default, lowered_sat(want)]
            for sat in sats:
                sw_cell.SAT = sat or default
                try:
                    got = fn()
                    want16 = sat and sw_cell.score_bucket_cell_plain(t, q, m, p, exact=False)
                finally:
                    sw_cell.SAT = default
                if sat is None:
                    check(torch.equal(got, want), f"{name} {shape}: != B1 plain")
                else:
                    check_sat_rule(f"{name} {shape}", got, want16, sat)
                    check_sat_rule(f"{name} {shape} vs exact", got, want, sat)
            rows.append({"check": name, "shape": list(shape), "nq": 464,
                         **({"equal": True} if exact else {"sat_rule": True, "sat": sats}),
                         "ms": cuda_ms(fn), "b1_ms": b1_ms[exact]})
        for P in (2, 4):
            check(torch.equal(score_pair(t, q, m, p, P=P), want), f"B8 P={P} {shape}: != B1 plain")
            rows.append({"check": f"B8 pair P={P}", "shape": list(shape), "nq": 464, "equal": True,
                         "ms": cuda_ms(lambda: score_pair(t, q, m, p, P=P)), "b1_ms": b1_ms[True]})


# --------------------------------------------------------------- phase 3

def run_cli(module, argv):
    """Run a CLI entry point in this process; returns (rc, stdout text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.run(argv)
    return rc, buf.getvalue()


def phase_golden():
    from cudasw4_tpu_torch.cli import align, makedb

    t_phase = time.perf_counter()
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
    emit({"phase": "golden", "tsv_equal": ["blosum62", "blosum62_full"],
          "seconds": time.perf_counter() - t_phase})


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


def read_query_set():
    """The reference's 20 benchmark queries: [(header, sequence)]."""
    out = []
    with open(QUERY_SET) as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                out.append([line[1:], ""])
            elif line:
                out[-1][1] += line
    return [tuple(r) for r in out]


def wrappers():
    """The kernels' counters by short name: (wrapper, mode), the mode ""
    for exact state and "16" for int16 state; each wrapper counts its
    launches and its plain calls per mode."""
    from cudasw4_tpu_torch.ops import sw_cell, sw_col, sw_row
    from cudasw4_tpu_torch.tools.pairbench import score_pair

    return {
        "cell": (sw_cell.score_bucket_cell, ""), "cell16": (sw_cell.score_bucket_cell, "16"),
        "row": (sw_row.score_bucket_row, ""),
        "col": (sw_col.score_bucket_col, ""), "col16": (sw_col.score_bucket_col, "16"),
        "cell_batch": (sw_cell.score_bucket_cell_batch, ""),
        "cell_batch16": (sw_cell.score_bucket_cell_batch, "16"),
        "col_flat": (sw_col.score_bucket_col_flat, ""),
        "col_flat16": (sw_col.score_bucket_col_flat, "16"),
        "col_fused": (sw_col.score_bucket_col_flat_fused, ""),
        "col_fused16": (sw_col.score_bucket_col_flat_fused, "16"),
        "manual": (sw_cell.score_bucket_cell_manual, ""),
        "manual16": (sw_cell.score_bucket_cell_manual, "16"),
        "pair": (score_pair, ""),
    }


def reset_counts():
    for fn, mode in wrappers().values():
        setattr(fn, "launches" + mode, 0)
        setattr(fn, "plain_calls" + mode, 0)


def read_counts():
    return {name: (getattr(fn, "launches" + mode), getattr(fn, "plain_calls" + mode))
            for name, (fn, mode) in wrappers().items()}


def check_path(counts, path, launched):
    """The run ``path`` launched every kernel of ``launched`` and ran no
    plain version."""
    for name, (launches, plain) in counts.items():
        check(plain == 0, f"{path}: the {name} plain version ran {plain} times")
    for name in launched:
        check(counts[name][0] > 0, f"{path}: the {name} kernel never launched")


#: The kernels each launch counter (``wrappers``) can stand for: its state
#: modes and its routes (B1 and B4 in s16x2 lanes in both modes; past the
#: largest cell instance, the col kernels).
COUNTER_KERNELS = {
    "cell": ("sw_cell16_kernel", "sw_col_kernel"),
    "cell16": ("sw_cell16_kernel", "sw_col16_kernel"),
    "row": ("sw_row_kernel", "sw_row_col_kernel"),
    "col": ("sw_col_kernel",), "col16": ("sw_col16_kernel",),
    "cell_batch": ("sw_cell16_kernel", "sw_col_flat_kernel"),
    "cell_batch16": ("sw_cell16_kernel", "sw_col_flat16_kernel"),
    "col_flat": ("sw_col_flat_kernel",), "col_flat16": ("sw_col_flat16_kernel",),
    "col_fused": ("sw_col_fused_kernel",), "col_fused16": ("sw_col_fused16_kernel",),
    "manual": ("sw_manual_kernel", "sw_col_kernel"),
    "manual16": ("sw_manual16_kernel", "sw_col16_kernel"),
    "pair": ("sw_pair_kernel", "sw_col_kernel"),
}


def trace_mismatch(traced, launched):
    """Where a trace's kernel counts by name (``traced``) differ from the
    launch counters' deltas (``launched``, by counter name): counters that
    can stand for a common kernel form one group with their kernels, and a
    group's traced kernels must number its counters' launches.  Returns the
    groups that differ: [{"kernels", "traced", "launched"}]; a traced port
    kernel that no counter stands for is a group of its own."""
    groups = []
    for counter, names in COUNTER_KERNELS.items():
        g = (set(names), {counter})
        for other in [o for o in groups if o[0] & g[0]]:
            groups.remove(other)
            g[0].update(other[0])
            g[1].update(other[1])
        groups.append(g)
    known = set().union(*(g[0] for g in groups))
    groups += [({n}, set()) for n in traced if n != "other" and n not in known]
    out = []
    for names, counters in groups:
        t = sum(traced.get(n, 0) for n in names)
        n = sum(launched.get(c, 0) for c in counters)
        if t != n:
            out.append({"kernels": sorted(names), "traced": t, "launched": n})
    return out


def device_idle_share(run, name="queries_trace.json"):
    """Trace ``run`` with torch.profiler into WORK/``name`` and measure the
    card's idle share:
    1 - (union of the device's kernel, copy and set intervals) / (first
    device start to last device end).  Returns a dict with the share, the
    spans in microseconds, the trace's kernels (the port's by name,
    PyTorch's as "other") and the launch counters' deltas across ``run``.
    The share is None, with the reason, when the trace holds no device
    events or when its port kernels do not number the launches (a trace
    that dropped kernels would understate the busy time)."""
    from cudasw4_tpu_torch.utils.profiling import device_trace

    before = read_counts()
    with device_trace(WORK, name) as path:
        run()
    after = read_counts()
    launched = {k: after[k][0] - before[k][0] for k in after if after[k][0] != before[k][0]}
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
        return {"device_idle_share": None, "reason": "no device events in the trace",
                "launches": launched}
    mismatch = trace_mismatch(names, launched)
    if mismatch:
        return {"device_idle_share": None,
                "reason": "the trace's kernels do not number the launches: " + "; ".join(
                    f"{'/'.join(m['kernels'])} traced {m['traced']}, launched {m['launched']}"
                    for m in mismatch),
                "kernels": names, "launches": launched, "mismatch": mismatch}
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
            "device_span_us": span, "kernels": names, "launches": launched}


def kernel_source(name: str) -> str:
    """The source file of a kernel of the library (csrc/)."""
    unit = "sw_col.cu" if name.startswith(("sw_col", "sw_row_col")) else "sw_cell.cuh"
    return f"cudasw4_tpu_torch/csrc/{unit}"


def phase_sprot(clock_mhz):
    from cudasw4_tpu_torch import make_scoring_config
    from cudasw4_tpu_torch.cli import align, makedb
    from cudasw4_tpu_torch.constants import encode
    from cudasw4_tpu_torch.db.format import load_db
    from cudasw4_tpu_torch.engine import SearchEngine
    from cudasw4_tpu_torch.ops import (
        batch_col_scores, col_flat_plan, cuda_lib, oracle, score_bucket, sw_cell, sw_col, sw_row,
    )

    t_phase = time.perf_counter()
    d = os.path.join(WORK, "sprot")
    os.makedirs(d, exist_ok=True)
    fasta, prefix = os.path.join(d, "sprot.fa"), os.path.join(d, "sprot")
    tsv = os.path.join(d, "hits.tsv")
    t0 = time.perf_counter()
    residues = write_sprot_fasta(fasta)
    queries = [seq for _, seq in read_query_set()]
    check(len(queries) == 20, f"{QUERY_SET}: {len(queries)} queries, expected 20")
    t_fasta = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc, _ = run_cli(makedb, [fasta, prefix])
    check(rc == 0, "sprot makedb failed")
    t_makedb = time.perf_counter() - t0

    # The main path: align on the 20 queries.
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc, out = run_cli(align, [
        "--query", QUERY_SET, "--db", prefix, "--top", "10", "--tsv", "--verbose", "--of", tsv,
    ])
    t_align = time.perf_counter() - t0
    counts = read_counts()
    align_peak = torch.cuda.max_memory_allocated()
    check(rc == 0, "sprot align failed")
    check_path(counts, "align", ("cell", "row", "col", "cell_batch", "col_flat"))
    check(not any(counts[k][0] for k in ("cell16", "col16", "cell_batch16", "col_flat16",
                                          "col_fused16", "manual", "manual16", "pair")),
          "align launched an int16 or tool kernel")
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

    # The batch as align formed it: the plan, the launches, and every
    # slot's scores against the single-query kernels'.
    eng = SearchEngine(scoring=cfg, num_top=10)
    eng.set_database(db)
    qcap_b = eng._qcap_batch
    codes = [encode(q) for q in queries]
    group = [c for c in codes if len(c) <= qcap_b]
    singles = [c for c in codes if len(c) > qcap_b]
    check(len(group) == 14 and len(singles) == 6 and all(g is c for g, c in zip(group, codes)),
          f"batch of {len(group)} and {len(singles)} singles, expected 14 and 6")
    S = len(group)
    qarr, nqs, pads, params = eng._batch_slot_params(enumerate(group), S, qcap_b)
    plan = col_flat_plan(pads, limit=S, rtot=qcap_b)
    pass_sizes = sorted(len(p) for p in plan)
    check(pass_sizes == [1, 2, 2, 3, 6], f"col plan passes of {pass_sizes} slots, expected 1, 2, 2, 3, 6")
    kinds = {}
    for b in eng.packed.buckets:
        kinds[b.kernel] = kinds.get(b.kernel, 0) + 1
    check(counts["cell_batch"][0] == kinds["cell"], "cell batch launches != cell buckets")
    check(counts["col_flat"][0] == len(plan) * kinds["col"], "col flat launches != passes x col buckets")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    (batch_scores, batch_ms) = timed(lambda: eng.batch_slot_scores(group))
    batch_peak = torch.cuda.max_memory_allocated() - base_bytes
    single_scores, singles_ms = timed(lambda: [eng.slot_scores(c) for c in group])
    valid = eng._valid
    for i, c in enumerate(group):
        n_equal = int((batch_scores[i][valid] == single_scores[i][valid]).sum())
        check(n_equal == db.num_sequences,
              f"batch slot {i} ({len(c)} aa): {db.num_sequences - n_equal} scores differ from singles")
    del single_scores
    group_cells = float(sum(len(c) for c in group)) * eng.packed.total_real_chars

    # The fused col kernel on passes of at least 3 slots: same scores.
    sw_col.COL_FUSE_MIN_S = 3
    try:
        reset_counts()
        fused_results = eng.scan_batch(group)
        fused_counts = read_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live_bytes = torch.cuda.memory_allocated()  # the database and the flat batch's scores
        fused_scores = eng.batch_slot_scores(group)
        fused_peak = torch.cuda.max_memory_allocated() - live_bytes
    finally:
        sw_col.COL_FUSE_MIN_S = 0
    n_fused_passes = sum(1 for p in plan if len(p) >= 3)
    check(fused_counts["col_fused"][0] == n_fused_passes * kinds["col"],
          f"fused launches {fused_counts['col_fused'][0]}, expected {n_fused_passes * kinds['col']}")
    check(all(v[1] == 0 for v in fused_counts.values()), "a plain version ran in the fused batch")
    check(torch.equal(fused_scores, batch_scores), "fused batch scores differ from the flat batch")
    plain_results = eng.scan_batch(group)
    check([(r.scores, r.reference_ids) for r in fused_results]
          == [(r.scores, r.reference_ids) for r in plain_results], "fused batch results differ")
    del fused_scores

    # Per-kernel timings at the main-path shapes.
    kernels = []
    mid = encode(queries[4])  # the 464-aa query: one col chunk
    check(len(mid) == 464, "the fifth query is not the 464-aa one")
    qp, prm = eng._single_qpad(mid)
    qm = torch.as_tensor(qp).cuda()
    largest = {kind: max((k for k, b in enumerate(eng.packed.buckets) if b.kernel == kind),
                         key=lambda k: eng.packed.buckets[k].tiles.size)
               for kind in kinds}

    def kernel_row(name, replaces, path, launches, shape, nrows, real_rows, bucket, got, want,
                   ms, pms, slots=1, state="int32", lanes=None, **extra):
        """One row of the kernels line; ``lanes`` (the bound's) defaults to
        s16x2 for int16 state, int32 for exact state."""
        err = float((got - want).abs().max())
        check(err == 0.0, f"{name} differs from plain at the main-path shape {tuple(shape)}")
        real, padded = cell_counts(shape, nrows, real_rows, int(eng.packed.buckets[bucket].lengths.sum()))
        nbytes = int(np.prod(shape)) + 4 * nrows + 4 * slots * shape[0] * int(np.prod(shape[2:]))
        lanes = lanes or ("int32" if state == "int32" else "s16x2")
        b_ms, by = bound(real, nbytes, clock_mhz, lanes)
        kernels.append({
            "name": name, "route": "cuda", "source": kernel_source(name),
            "replaces": replaces, "path": path, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": pms, "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "state": state, "lanes": lanes, "equal": True, "shape": list(shape), "nq": nrows, "slots": slots,
            "cells_real": real, "cells_padded": padded,
            "gcups_real": real / ms / 1e6, "gcups_padded": padded / ms / 1e6, **extra,
        })

    # Each kind's row names by mode (exact, int16): B1 runs the s16x2
    # kernel in both.
    singles_kernels = {
        "cell": (sw_cell.score_bucket_cell, sw_cell.score_bucket_cell_plain,
                 "cudasw4_tpu/ops/sw_pallas_cell.py:506",
                 ("sw_cell16_kernel[exact]", "sw_cell16_kernel")),
        "row": (sw_row.score_bucket_row, sw_row.score_bucket_row_plain,
                "cudasw4_tpu/ops/sw_pallas.py:138", ("sw_row_kernel", None)),
        "col": (sw_col.score_bucket_col, sw_col.score_bucket_col_plain,
                "cudasw4_tpu/ops/sw_pallas_col.py:220", ("sw_col_kernel", "sw_col16_kernel")),
    }
    cell_plain = {}  # B1's plain scores and ms by mode, for B7 and B8
    for kind, (fn, plain, replaces, knames) in singles_kernels.items():
        i = largest[kind]
        t = eng._bucket_tiles[i]
        if kind == "col":
            nrows = int(prm[3])
            p = (nrows, int(prm[1]), int(prm[2]), nrows)
            q = qm[: sw_col.NQC]
        else:
            nrows, p, q = len(mid), prm, qm
        for exact in (True,) if kind == "row" else (True, False):  # the row kernel: int32 only
            kw = {} if kind == "row" else {"exact": exact}
            # The col kernel as the main path launches it, with the tiles'
            # lengths; also timed without them.
            kl = {"lengths": eng._bucket_lengths[i]} if kind == "col" else {}
            a = fn(t, q, eng._matrix_flat, p, **kw, **kl)
            b = plain(t, q, eng._matrix_flat, p, **kw)
            ms = cuda_ms(lambda: fn(t, q, eng._matrix_flat, p, **kw, **kl))
            pms = cuda_ms(lambda: plain(t, q, eng._matrix_flat, p, **kw), reps=1)
            # int16 state: its launches come from the align --dpx run.
            extra = {}
            if kind == "cell":
                shape = sw_cell.cell_shape(t.shape[1])
                extra = {"cell_shape": list(shape), "scratch_bytes": 0, "lanes": "s16x2"}
                if exact:  # the int32 kernel it replaces, on the same inputs
                    extra["int32_ms"] = cuda_ms(lambda: cuda_lib.launch_cell(
                        fn, "sw_cell_kernel", t, q[:nrows].view(1, nrows), eng._matrix_flat,
                        int(p[1]), int(p[2]), nrows, shape))
            elif kind == "row":
                route, cell, _, pool = sw_row.row_route(*t.shape, len(mid))
                extra = {"row_route": route, "cell_shape": cell and list(cell),
                         "scratch_bytes": pool}
            else:
                a0 = fn(t, q, eng._matrix_flat, p, **kw)
                check(torch.equal(a0, b), f"{kind} without lengths differs from plain")
                extra = {"without_lengths_ms": cuda_ms(lambda: fn(t, q, eng._matrix_flat, p, **kw))}
            kernel_row(knames[0] if exact else knames[1], replaces,
                       "align" if exact else "align --dpx", counts[kind][0] if exact else 0,
                       tuple(t.shape), nrows, len(mid), i, a, b, ms, pms,
                       state="int32" if exact else "int16", **extra)
            if kind == "cell":
                cell_args, cell_plain[exact] = (i, t, q, p), (b, pms)

    # B7 (both modes) and B8 at the same bucket and query as B1, against
    # B1's plain version in the same mode; the exact kernels' launches
    # come from the tools phase; no path reaches B7 int16 (the tools run
    # exact).
    from cudasw4_tpu_torch.tools.pairbench import score_pair

    i, t, q, p = cell_args
    for name, replaces, path, exact, fn in (
        ("sw_manual_kernel", "cudasw4_tpu/ops/sw_pallas_cell.py:448", "dmabench", True,
         lambda: sw_cell.score_bucket_cell_manual(t, q, eng._matrix_flat, p)),
        ("sw_manual16_kernel", "cudasw4_tpu/ops/sw_pallas_cell.py:448", None, False,
         lambda: sw_cell.score_bucket_cell_manual(t, q, eng._matrix_flat, p, exact=False)),
        ("sw_pair_kernel", "tools/pairbench.py:45", "pairbench", True,
         lambda: score_pair(t, q, eng._matrix_flat, p, P=2)),
    ):
        want, pms = cell_plain[exact]
        kernel_row(name, replaces, path, 0, tuple(t.shape), len(mid), len(mid), i, fn(), want,
                   cuda_ms(fn), pms, state="int32" if exact else "int16",
                   cell_shape=list(sw_cell.cell_shape(t.shape[1])), scratch_bytes=0)

    # B4 at the largest cell bucket with the batch of 14; B5 and B6 at the
    # largest col bucket with the plan's widest pass, given the bucket's
    # lengths as the main path gives them (each also timed without).
    qdev = torch.as_tensor(qarr).cuda()
    i = largest["cell"]
    t = eng._bucket_tiles[i]
    a = sw_cell.score_bucket_cell_batch(t, qdev, eng._matrix_flat, params)
    b, pms = timed(lambda: sw_cell.score_bucket_cell_batch_plain(t, qdev, eng._matrix_flat, params))
    ms = cuda_ms(lambda: sw_cell.score_bucket_cell_batch(t, qdev, eng._matrix_flat, params))
    shape = sw_cell.cell_shape(t.shape[1])
    # The int32 kernel it replaces, on the same inputs.
    ms32 = cuda_ms(lambda: cuda_lib.launch_cell(
        sw_cell.score_bucket_cell_batch, "sw_cell_batch_kernel", t, qdev, eng._matrix_flat,
        int(params[1]), int(params[2]), [int(n) for n in nqs], shape))
    kernel_row("sw_cell16_kernel[batch,exact]", "cudasw4_tpu/ops/sw_pallas_cell.py:343", "align",
               counts["cell_batch"][0], tuple(t.shape), int(sum(nqs)), int(sum(nqs)), i, a, b,
               ms, pms, slots=S, lanes="s16x2", int32_ms=ms32, cell_shape=list(shape),
               scratch_bytes=0)
    # B4 int16 (no path reaches it: no launches) on the same inputs: at
    # the default SAT, equal to the exact kernel's scores.
    def fn():
        return sw_cell.score_bucket_cell_batch(t, qdev, eng._matrix_flat, params, exact=False)
    a16 = fn()
    check(torch.equal(a16, a), "B4 int16 at the main-path shape: != the exact kernel's scores")
    b16, pms16 = timed(lambda: sw_cell.score_bucket_cell_batch_plain(
        t, qdev, eng._matrix_flat, params, exact=False))
    kernel_row("sw_cell16_kernel[batch]", "cudasw4_tpu/ops/sw_pallas_cell.py:343", None, 0,
               tuple(t.shape), int(sum(nqs)), int(sum(nqs)), i, a16, b16, cuda_ms(fn), pms16,
               slots=S, state="int16", equal_to_exact=True,
               cell_shape=list(sw_cell.cell_shape(t.shape[1])), scratch_bytes=0)
    del a, b, a16, b16
    widest = max(plan, key=len)
    idx = [slot for slot, _ in widest]
    offs = tuple(o for _, o in widest)
    qs = qdev[idx].contiguous()
    pcol = [int(v) for v in params[:4]] + [int(pads[s]) for s in idx]
    real_rows = int(sum(nqs[s] for s in idx))
    i = largest["col"]
    t = eng._bucket_tiles[i]
    plains = {exact: timed(lambda exact=exact: sw_col.score_bucket_col_flat_plain(
        t, qs, eng._matrix_flat, pcol, exact=exact)) for exact in (True, False)}
    check(torch.equal(plains[True][0], plains[False][0]),
          "B5 plain int16 at the main-path shape: != exact at the default SAT")
    # Each mode's (path, launches): B5 int16's path is phase colstate16,
    # which replaces this row's figures with its own shape's; no path
    # reaches B6 int16.
    for name, replaces, modes, wrapper, args in (
        ("sw_col_flat_kernel", "cudasw4_tpu/ops/sw_pallas_col.py:721",
         {True: ("align", counts["col_flat"][0]), False: ("colstate16", 0)},
         sw_col.score_bucket_col_flat, (offs,)),
        ("sw_col_fused_kernel", "cudasw4_tpu/ops/sw_pallas_col.py:796",
         {True: (FUSED_PATH, fused_counts["col_fused"][0]), False: (None, 0)},
         sw_col.score_bucket_col_flat_fused, ()),
    ):
        for exact, (path, launches) in modes.items():
            def fn(wrapper=wrapper, args=args, exact=exact, lengths=eng._bucket_lengths[i]):
                return wrapper(t, qs, eng._matrix_flat, pcol, *args, rtot=qcap_b, exact=exact,
                               lengths=lengths)
            a = fn()
            ms = cuda_ms(fn)
            b, pms = plains[exact]
            check(torch.equal(fn(lengths=None), b), f"{name} {exact} without lengths: != plain")
            pool_rows = sum(pcol[4:]) if "fused" in name else qcap_b
            extra = {"boundary_bytes": cuda_lib.col_boundary_bytes(t.shape[0], pool_rows,
                                                                   0 if exact else 1),
                     "without_lengths_ms": cuda_ms(lambda: fn(lengths=None))}
            if not exact:
                extra["equal_to_exact"] = True
            kernel_row(name if exact else name.replace("_kernel", "16_kernel"), replaces,
                       path, launches, tuple(t.shape), sum(pcol[4:]), real_rows, i, a, b, ms, pms,
                       slots=len(idx), state="int32" if exact else "int16",
                       pass_offsets=list(offs), **extra)
    del plains, a, b

    # Every cell bucket with the 464-aa query, both state modes: its
    # (G, R), time, bound and share of the bound.
    cell_buckets = []
    for k, (t, b) in enumerate(zip(eng._bucket_tiles, eng.packed.buckets)):
        if b.kernel != "cell":
            continue
        line = {"L": b.L, "tiles": int(t.shape[0]), "cell_shape": list(sw_cell.cell_shape(b.L)),
                "real_share": int(b.lengths.sum()) / t.numel()}
        for exact, state in ((True, "int32"), (False, "int16")):
            ms = cuda_ms(lambda: sw_cell.score_bucket_cell(t, qm, eng._matrix_flat, prm, exact=exact))
            real = len(mid) * int(b.lengths.sum())
            b_ms, _ = bound(real, t.numel() + 4 * len(mid) + 4 * t.shape[0] * 4096, clock_mhz,
                            "s16x2")
            line[state] = {"ms": ms, "bound_ms": b_ms, "share": b_ms / ms}
        cell_buckets.append(line)

    # Where a query's device time goes: each bucket timed alone (CUDA
    # events), summed by kernel kind, per ladder query; and the batch's.
    by_len = {len(c): c for c in codes}
    breakdown = {}
    for n in QUERY_LADDER:
        c = by_len[n]
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
        breakdown[n] = by_kind
    batch_by_kind = {}
    for t, b in zip(eng._bucket_tiles, eng.packed.buckets):
        if b.kernel == "cell":
            def fn(t=t):
                return sw_cell.score_bucket_cell_batch(t, qdev, eng._matrix_flat, params)
        elif b.kernel == "col":
            def fn(t=t):
                return list(batch_col_scores(t, qdev, eng._matrix_flat, params, S, plan, rtot=qcap_b))
        else:
            def fn(t=t):
                return [sw_row.score_bucket_row(t, qdev[k], eng._matrix_flat,
                                                (int(nqs[k]), cfg.gop, cfg.gex, int(pads[k])))
                        for k in range(S)]
        batch_by_kind[b.kernel] = batch_by_kind.get(b.kernel, 0.0) + cuda_ms(fn, reps=1)

    profiled = device_idle_share(lambda: list(eng.scan_many(queries)))

    emit({
        "phase": "sprot", "sequences": db.num_sequences, "residues": residues,
        "buckets": kinds, "padded_db_bytes": eng.packed.total_padded_chars,
        "query_lengths": [len(c) for c in codes], "batch_queries": S, "single_queries": len(singles),
        "col_plan_pass_slots": [len(p) for p in plan],
        "query_seconds": [s for s, _ in per_query], "query_gcups": [g for _, g in per_query],
        "total_seconds": total_s, "total_gcups": total_gcups,
        "stream_occupancy_between_queries": sum(q for q, _ in per_query) / total_s,
        "batch14_ms": batch_ms, "batch14_gcups": group_cells / batch_ms / 1e6,
        "singles14_ms": singles_ms, "singles14_gcups": group_cells / singles_ms / 1e6,
        "batch14_ms_by_kind": batch_by_kind,
        "batch14_col_share": batch_by_kind["col"] / sum(batch_by_kind.values()),
        "batch14_peak_device_bytes_above_db": batch_peak,
        "fused_batch14_peak_device_bytes_above_db": fused_peak,
        "bucket_ms_by_kind": breakdown,
        "cell_share_by_query": {n: v.get("cell", 0.0) / sum(v.values()) for n, v in breakdown.items()},
        "cell_buckets_464": cell_buckets,
        "profiled_20_queries": profiled,
        "align_run_seconds": t_align, "makedb_seconds": t_makedb, "fasta_seconds": t_fasta,
        "align_peak_device_bytes": align_peak,
        "launches": {k: v[0] for k, v in counts.items()},
        "plain_calls": {k: v[1] for k, v in counts.items()},
        "fused_batch_launches": {k: v[0] for k, v in fused_counts.items()},
        "hits_checked": sum(len(h) for h in hits.values()),
        "batch_slot_scores_equal_singles": S * db.num_sequences,
        "seconds": time.perf_counter() - t_phase,
    })
    ctx = {"prefix": prefix, "tsv": tsv, "queries": queries, "db": db, "cfg": cfg, "eng": eng,
           "total_gcups": total_gcups, "fasta": fasta, "align_peak": align_peak}
    return {k["name"]: k for k in kernels}, ctx


# ------------------------------------------------------ phase state16

def planted_db(rng, planted, n=6000):
    """A small database whose long tail packs into col buckets: ``n``
    random subjects of planted - 200 .. planted + 99 aa and one of
    ``planted`` W's, sorted by
    length ascending as makedb stores them (the planted one at a random
    place among the subjects of its length).  Returns (DBData, the planted
    subject's id)."""
    from cudasw4_tpu_torch.constants import encode
    from cudasw4_tpu_torch.db.format import DBData

    lens = np.sort(rng.integers(planted - 200, planted + 100, size=n))
    seqs = [rng.integers(0, 20, size=int(k)).astype(np.int8) for k in lens]
    lo, hi = np.searchsorted(lens, planted, "left"), np.searchsorted(lens, planted, "right")
    at = int(rng.integers(lo, hi + 1))
    seqs.insert(at, encode("W" * planted))
    lens = np.array([len(x) for x in seqs], np.int32)
    offsets = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum((lens + 3) // 4 * 4, out=offsets[1:])
    chars = np.full(int(offsets[-1]), 20, np.int8)
    for x, a in zip(seqs, offsets[:-1]):
        chars[a : a + len(x)] = x
    return DBData(chars=chars, offsets=offsets.astype(np.uint64), lengths=lens,
                  headers=np.zeros(0, np.uint8),
                  header_offsets=np.zeros(len(seqs) + 1, np.uint64)), at


def phase_state16(ctx, kernels):
    """The int16-state path: align --dpx on the 20 queries (TSV equal to
    the exact run's; its counters are the int16 kernels' launches), again
    with SAT lowered to the median top score so that real tiles flag
    (TSV equal again, re-scored tiles and exact launches counted), a
    planted 34,100 hit above the default SAT on a small database, and the
    20 queries as singles in int16 and in int32 state, timed in turns."""
    from cudasw4_tpu_torch.cli import align
    from cudasw4_tpu_torch.constants import encode
    from cudasw4_tpu_torch.engine import SearchEngine
    from cudasw4_tpu_torch.ops import sw_cell

    t_phase = time.perf_counter()
    d = os.path.join(WORK, "sprot")
    with open(ctx["tsv"]) as f:
        exact_text = f.read()

    def align_dpx(name):
        tsv = os.path.join(d, name)
        rc, out = run_cli(align, ["--query", QUERY_SET, "--db", ctx["prefix"], "--top", "10",
                                  "--tsv", "--verbose", "--of", tsv, "--dpx"])
        check(rc == 0, f"align --dpx ({name}) failed")
        with open(tsv) as f:
            text = f.read()
        check(text == exact_text, f"align --dpx ({name}): TSV differs from the exact run's")
        total = [line for line in out.splitlines() if line.startswith("Total time:")][0]
        return float(total.split(", ")[1].replace(" GCUPS", ""))

    # The int16 modes' main path.
    reset_counts()
    dpx_gcups = align_dpx("hits_dpx.tsv")
    counts = read_counts()
    check_path(counts, "align --dpx", ("cell16", "row", "col16"))
    check(not any(counts[k][0] for k in ("cell_batch", "col_flat", "col_fused", "cell_batch16",
                                          "col_flat16", "col_fused16")),
          "align --dpx launched a batch kernel")
    kernels["sw_cell16_kernel"]["launches"] = counts["cell16"][0]
    kernels["sw_col16_kernel"]["launches"] = counts["col16"][0]

    # SAT lowered so that real tiles flag: the re-score and its merge.
    tops = sorted(int(line.split("\t")[4]) for line in exact_text.splitlines()[1:]
                  if line.split("\t")[3] == "0")
    sat_low = tops[len(tops) // 2]
    flagged, real_rescore = [], SearchEngine._rescore_overflow

    def spy(self, tmaxes, vals, ids, codes):
        flagged.append(sum(int((tm >= sw_cell.SAT).sum()) for tm in tmaxes))
        return real_rescore(self, tmaxes, vals, ids, codes)

    default_sat = sw_cell.SAT
    SearchEngine._rescore_overflow, sw_cell.SAT = spy, sat_low
    try:
        reset_counts()
        low_gcups = align_dpx("hits_dpx_lowered_sat.tsv")
        low_counts = read_counts()
    finally:
        SearchEngine._rescore_overflow, sw_cell.SAT = real_rescore, default_sat
    check(len(flagged) > 0, f"no query re-scored at SAT={sat_low}")
    low_flagged = list(flagged)
    check_path(low_counts, "align --dpx at a lowered SAT", ("cell16", "col16"))

    # A planted hit above the default SAT: 3,100 W against 3,100 W.
    db, at = planted_db(np.random.default_rng(5), PLANTED_W)
    w = int(encode("W")[0])
    top = PLANTED_W * int(ctx["cfg"].matrix[w, w])
    check(top >= sw_cell.SAT, f"the planted score {top} does not reach SAT={sw_cell.SAT}")
    eng = SearchEngine(scoring=ctx["cfg"], num_top=10)
    eng.state16 = True
    eng.set_database(db)
    kinds = [b.kernel for b in eng.packed.buckets]
    tiles_total = sum(b.num_tiles for b in eng.packed.buckets)
    exact_tiles, real_score = [], SearchEngine._score_bucket

    def score_spy(self, tiles, kind, codes, qdev, params, exact, *rest, **kw):
        if exact:  # the fast pass is int16: exact calls are the re-score's
            exact_tiles.append(int(tiles.shape[0]))
        return real_score(self, tiles, kind, codes, qdev, params, exact, *rest, **kw)

    flagged.clear()
    SearchEngine._rescore_overflow, SearchEngine._score_bucket = spy, score_spy
    try:
        reset_counts()
        res = eng.scan("W" * PLANTED_W)
        planted_counts = read_counts()
    finally:
        SearchEngine._rescore_overflow, SearchEngine._score_bucket = real_rescore, real_score
    check(len(flagged) == 1, f"planted hit: {len(flagged)} re-scores, expected 1")
    check(res.scores[0] == top and res.reference_ids[0] == at,
          f"planted hit: {res.scores[0]} at {res.reference_ids[0]}, expected {top} at {at}")
    check(res.stats.num_overflows >= 1, "planted hit: no overflow counted")
    check(exact_tiles and sum(exact_tiles) == flagged[0] < tiles_total,
          f"planted hit: exact scoring over {exact_tiles} tiles, {flagged} flagged of {tiles_total}")
    check_path(planted_counts, "planted hit", ("col16", "col"))
    del eng

    # int16 against int32 state, the 20 queries as singles, in turns.
    eng = ctx["eng"]
    ms = {"int32": [], "int16": []}
    for q in ctx["queries"]:
        for state16 in (False, True):
            eng.state16 = state16
            _, t = timed(lambda: eng.scan(q))
            ms["int16" if state16 else "int32"].append(t)
    eng.state16 = False
    cells = float(sum(len(q) for q in ctx["queries"])) * eng.packed.total_real_chars
    emit({
        "phase": "state16", "dpx_total_gcups": dpx_gcups, "exact_total_gcups": ctx["total_gcups"],
        "dpx_launches": {k: v[0] for k, v in counts.items()},
        "lowered_sat": sat_low, "lowered_sat_total_gcups": low_gcups,
        "lowered_sat_rescored_queries": len(low_flagged), "lowered_sat_flagged_tiles": low_flagged,
        "lowered_sat_launches": {k: v[0] for k, v in low_counts.items()},
        "planted": {"buckets": kinds, "tiles": tiles_total, "top": res.scores[0],
                    "num_overflows": res.stats.num_overflows, "flagged_tiles": flagged,
                    "exact_tiles": exact_tiles,
                    "launches": {k: v[0] for k, v in planted_counts.items()}},
        "singles_ms_int32": ms["int32"], "singles_ms_int16": ms["int16"],
        "singles_gcups_int32": cells / sum(ms["int32"]) / 1e6,
        "singles_gcups_int16": cells / sum(ms["int16"]) / 1e6,
        "seconds": time.perf_counter() - t_phase,
    })


# ---------------------------------------------------- phase long_query

def phase_long_query(ctx):
    """The two longest reference queries joined (> QCAP = 8192 aa) against
    the Swiss-Prot-scale database: its hits against the vectorised oracle
    and its GCUPS."""
    from cudasw4_tpu_torch.constants import encode
    from cudasw4_tpu_torch.ops import oracle, sw_cell

    t_phase = time.perf_counter()
    eng, db, cfg = ctx["eng"], ctx["db"], ctx["cfg"]
    longest = sorted(ctx["queries"], key=len)[-2:]
    codes = encode(longest[1] + longest[0])
    check(len(codes) > sw_cell.QCAP, f"joined query of {len(codes)} aa is not beyond QCAP")
    reset_counts()
    res, ms = timed(lambda: eng.scan(codes))
    counts = read_counts()
    check_path(counts, "long query", ("cell", "row", "col"))
    hs = list(zip(res.scores, res.reference_ids))
    check(hs == sorted(hs, key=lambda h: (-h[0], h[1])), "long query: hits out of order")
    subs = [db.get_sequence(r) for r in res.reference_ids]
    block = np.full((len(subs), max(len(x) for x in subs)), cfg.pad_code, np.int8)
    for k, x in enumerate(subs):
        block[k, : len(x)] = x
    want = oracle.sw_score_rowvec(codes, block, cfg.matrix, cfg.gop, cfg.gex)
    check(res.scores == [int(v) for v in want], "long query: scores differ from the oracle")
    ctx["long_query"] = (codes, hs)
    emit({"phase": "long_query", "query_aa": len(codes), "ms": ms,
          "gcups": len(codes) * eng.packed.total_real_chars / ms / 1e6,
          "hits": hs, "launches": {k: v[0] for k, v in counts.items()},
          "seconds": time.perf_counter() - t_phase})


# ------------------------------------------------------- phase routing

#: Phase routing's windows of the engine's COL_SINGLE_MIN_ROWS beside the
#: port's default: the JAX engine's 512, and 8, at which every query of
#: one NQC pass routes, so that each query's routed and unrouted times
#: give every threshold's total (``routing_totals``).
ROUTING_WINDOWS = {"jax": 512, "wide": 8}


def routing_totals(nq_pads, routed_ms, closed_ms, nqc):
    """The 20 singles' total milliseconds at each COL_SINGLE_MIN_ROWS that
    changes a route (every distinct nq_pad <= ``nqc``) and closed: a query
    takes its ``routed_ms`` where threshold <= nq_pad <= nqc, else its
    ``closed_ms``.  Returns {threshold or "closed": ms}."""
    out = {"closed": sum(closed_ms)}
    for t in sorted({p for p in nq_pads if p <= nqc}):
        out[t] = sum(r if t <= p <= nqc else c for p, r, c in zip(nq_pads, routed_ms, closed_ms))
    return out


def phase_routing(ctx):
    """The per-query-length routing (``SearchEngine.COL_SINGLE_MIN_ROWS``,
    ``_single_kinds``) on phase 4's database: each query's kernel kinds at
    each window; the 20 queries as singles in exact and in int16 state,
    with the window at the port's default, at the JAX engine's 512, at 8
    and, where the default opens it, closed, in turns (forward, then
    backward); every run writes phase
    4's TSV byte for byte, and the routed runs launch B3 (B3 int16) in
    place of B1 (B1 int16) on exactly the cell buckets that
    ``_single_kinds`` routes; every threshold's total from the wide and
    the closed runs, and the best one in each state."""
    from cudasw4_tpu_torch.cli.align import TSV_HEADER, print_scan_result_tsv
    from cudasw4_tpu_torch.constants import encode
    from cudasw4_tpu_torch.db.fasta import read_sequences
    from cudasw4_tpu_torch.engine import SearchEngine
    from cudasw4_tpu_torch.ops import sw_col

    t_phase = time.perf_counter()
    with open(ctx["tsv"]) as f:
        exact_text = f.read()
    records = list(read_sequences(QUERY_SET))
    codes = [encode(r.sequence) for r in records]
    eng = ctx["eng"]
    cells = float(sum(len(c) for c in codes)) * eng.packed.total_real_chars
    default = SearchEngine.COL_SINGLE_MIN_ROWS
    closed = sw_col.NQC + 1
    windows = {"default": default, **ROUTING_WINDOWS}
    if default <= sw_col.NQC:
        windows["closed"] = closed
    closed_name = "closed" if "closed" in windows else "default"
    nq_pads = [int(eng._single_qpad(c)[1][3]) for c in codes]
    base = eng._single_kinds(closed)

    def kinds_at(w):
        eng.COL_SINGLE_MIN_ROWS = w
        return [eng._single_kinds(p) for p in nq_pads]

    def routed(kinds):
        return sum(k != b for ks in kinds for k, b in zip(ks, base))

    try:
        kinds = {name: kinds_at(w) for name, w in windows.items()}
        expect = {name: routed(ks) for name, ks in kinds.items()}
        check(expect["jax"] > 0 and expect["wide"] > expect["jax"],
              f"the open windows route no cell bucket: {expect}")
        order = list(windows)
        runs = {state: {name: [] for name in windows} for state in ("int32", "int16")}
        for state in runs:
            eng.state16 = state == "int16"
            for name in order + order[::-1]:
                eng.COL_SINGLE_MIN_ROWS = windows[name]
                reset_counts()
                results = [eng.scan(c) for c in codes]
                counts = read_counts()
                out = io.StringIO()
                out.write(TSV_HEADER)
                for qi, (res, rec) in enumerate(zip(results, records)):
                    print_scan_result_tsv(out, res, eng, qi, len(rec.sequence), rec.header)
                check(out.getvalue() == exact_text,
                      f"routing {state} window {name}: TSV differs from phase 4's")
                runs[state][name].append({
                    "ms": [1e3 * r.stats.seconds for r in results],
                    "launches": {k: v[0] for k, v in counts.items()}})
                check_path(counts, f"routing {state} window {name}",
                           ("cell16", "col16") if state == "int16" else ("cell", "col"))
    finally:
        eng.state16 = False
        eng.__dict__.pop("COL_SINGLE_MIN_ROWS", None)
    mode = {"int32": "", "int16": "16"}
    summary = {}
    for state, by_window in runs.items():
        ref = by_window[closed_name][0]["launches"]
        for name, rs in by_window.items():
            for r in rs:
                col = r["launches"]["col" + mode[state]] - ref["col" + mode[state]]
                cell = ref["cell" + mode[state]] - r["launches"]["cell" + mode[state]]
                check(col == cell == expect[name],
                      f"routing {state} window {name}: {col} more B3 and {cell} fewer B1 "
                      f"launches, expected {expect[name]} routed buckets")
        mean = {name: [sum(x) / len(rs) for x in zip(*(r["ms"] for r in rs))]
                for name, rs in by_window.items()}
        totals = routing_totals(nq_pads, mean["wide"], mean[closed_name], sw_col.NQC)
        best = min(totals, key=lambda t: (totals[t], t == "closed"))
        summary[state] = {
            "gcups": {name: cells / sum(ms) / 1e6 for name, ms in mean.items()},
            "turn_gcups": {name: [cells / sum(r["ms"]) / 1e6 for r in rs]
                           for name, rs in by_window.items()},
            "query_ms": mean, "threshold_total_ms": {str(t): v for t, v in totals.items()},
            "best_threshold": best,
            "default_slower_than_closed": sum(mean["default"]) / sum(mean[closed_name]) - 1,
            "routed_b3_launches": {name: expect[name] for name in windows},
        }
    emit({"phase": "routing", "default_min_rows": default, "nqc": sw_col.NQC,
          "windows": windows, "nq_pads": nq_pads,
          "bucket_kinds": list(base), "bucket_L": [b.L for b in eng.packed.buckets],
          "routed_buckets": {name: [[i for i, (k, b) in enumerate(zip(ks, base)) if k != b]
                                    for ks in kinds[name]] for name in windows},
          **summary,
          "seconds": time.perf_counter() - t_phase})


# -------------------------------------------------------- phase stream

#: Phase stream's configuration: --maxGpuMem (the device budget that
#: stands in for a card too small for the database and a pass's working
#: memory) and --maxBatchBytes (the chunk cap), applied to phase 4's
#: database; 40-60% of its padded bytes then stream, and every streamed
#: align's peak device memory must stay within the budget.
STREAM_GPU_MEM, STREAM_BATCH_BYTES = "736M", "16M"
STREAM_SHARE = (0.40, 0.60)
#: The projection's database: TrEMBL's order of sequences, with phase 4's
#: length model (a projection from this run's rates, not a run).
TREMBL_SEQUENCES = 250_000_000


@contextlib.contextmanager
def environ(**kv):
    """Set environment variables for the block, then restore them."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def wall(fn):
    """(result, seconds) of ``fn`` on the host clock, the card synchronised
    before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_stream(ctx, kernels):
    """The streaming engine on phase 4's database under a device budget of
    STREAM_GPU_MEM: makedb --prepackStream builds the store and its b32
    sidecar; align streams the 20 queries (one pass: 14 batched, 6 one by
    one on every chunk), TSV byte for byte phase 4's, its counters B1-B5,
    its prefix within budget, its peak memory within STREAM_GPU_MEM and
    below the resident align's; the same with the prefix off, raw and b21
    chunks, --dpx (still exact) and COL_FUSE_MIN_S = 3 (B6); all 573k
    streamed scores of a 464-aa and a 5478-aa query against the resident
    engine's; then streamed against resident in turns (the 20 queries, and
    the 144-aa and 464-aa ones alone), the copy stream's and the link's GB/s, the
    unpack's ms per chunk, the idle share from traces of the 20 queries
    and of the 464-aa one (in a fresh process, ``stream_trace_child``), and
    a projection to a TrEMBL-sized database."""
    import shutil

    from cudasw4_tpu_torch.cli import align, makedb
    from cudasw4_tpu_torch.cli.align import parse_memory_string
    from cudasw4_tpu_torch.constants import encode
    from cudasw4_tpu_torch.db.format import load_db
    from cudasw4_tpu_torch.engine import SearchEngine
    from cudasw4_tpu_torch.engine_streaming import stream_work_bytes
    from cudasw4_tpu_torch.ops import pack5, sw_col

    t_phase = time.perf_counter()
    d = os.path.join(WORK, "sprot")
    with open(ctx["tsv"]) as f:
        exact_text = f.read()
    queries, cfg, res_eng = ctx["queries"], ctx["cfg"], ctx["eng"]
    budget = parse_memory_string(STREAM_GPU_MEM)

    # The store: a fresh prefix, so that makedb builds the tile store and
    # its sidecar in one pass.
    sprefix = os.path.join(d, "sprot_stream")
    store = ctx["stream_store"] = sprefix + "0.tpupack.npz"
    for path in (store, store + ".tiles"):
        if os.path.exists(path):
            os.remove(path)
    shutil.rmtree(store + ".pack5", ignore_errors=True)
    t0 = time.perf_counter()
    rc, out = run_cli(makedb, [ctx["fasta"], sprefix, "--prepackStream", STREAM_GPU_MEM])
    t_store = time.perf_counter() - t0
    check(rc == 0 and "TIMING: tile store + transfer sidecar" in out,
          f"makedb --prepackStream failed or wrote no sidecar: {out[-300:]}")
    store_bytes = {"tiles": os.path.getsize(store + ".tiles"), "npz": os.path.getsize(store),
                   "sidecar": sum(os.path.getsize(os.path.join(store + ".pack5", f))
                                  for f in os.listdir(store + ".pack5"))}

    engines, real_set = [], SearchEngine.set_database

    def spy(self, *a, **k):
        engines.append(self)
        return real_set(self, *a, **k)

    def stream_align(name, *extra, **env):
        """One streamed align of the 20 queries; its TSV must be phase 4's."""
        tsv = os.path.join(d, name)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        SearchEngine.set_database = spy
        try:
            with environ(**env):
                reset_counts()
                t0 = time.perf_counter()
                rc, out = run_cli(align, [
                    "--query", QUERY_SET, "--db", sprefix, "--top", "10", "--tsv", "--verbose",
                    "--of", tsv, "--maxGpuMem", STREAM_GPU_MEM, "--maxBatchBytes", STREAM_BATCH_BYTES,
                    *extra,
                ])
                seconds = time.perf_counter() - t0
                counts = read_counts()
        finally:
            SearchEngine.set_database = real_set
        peak = torch.cuda.max_memory_allocated() - base
        check(rc == 0, f"streamed align ({name}) failed")
        check(peak <= budget, f"streamed align ({name}): peak {peak} B above base "
                              f"passes --maxGpuMem {STREAM_GPU_MEM} ({budget} B)")
        with open(tsv) as f:
            check(f.read() == exact_text, f"streamed align ({name}): TSV differs from phase 4's")
        eng = engines[-1]
        check(eng.streaming, f"streamed align ({name}) did not stream")
        total = [line for line in out.splitlines() if line.startswith("Total time:")][0]
        check(not any(counts[k][0] for k in ("cell16", "col16", "manual", "manual16", "pair")),
              f"streamed align ({name}) launched an int16 or tool kernel")
        run = {"name": name, "gcups": float(total.split(", ")[1].replace(" GCUPS", "")),
               "align_seconds": seconds, "peak_device_bytes_above_base": peak,
               "codec": eng._stream_codec, "prefix_bytes": eng._prefix_bytes,
               "prefix_tile_bytes": sum(eng._res_tiles.get(bi, 0) * b.L * b.NS
                                        for bi, b in enumerate(eng.packed.buckets)),
               "prefix_budget": eng._prefix_budget(), "work_bytes": eng._work_bytes,
               "temp_bytes": eng._temp_bytes, **eng.stream_copy_stats(),
               "launches": {k: v[0] for k, v in counts.items()}}
        check_path(counts, f"streamed align ({name})", ())
        return run, counts, eng

    main, counts, eng = stream_align("hits_stream.tsv")
    padded = eng.packed.total_padded_chars
    share = 1.0 - main["prefix_tile_bytes"] / padded
    check_path(counts, "streamed align", ("cell", "row", "col", "cell_batch", "col_flat"))
    check(main["prefix_bytes"] <= max(0, main["prefix_budget"]), "the prefix exceeds its budget")
    check(STREAM_SHARE[0] <= share <= STREAM_SHARE[1],
          f"{share:.3f} of the padded bytes streamed, expected {STREAM_SHARE}")
    check(main["peak_device_bytes_above_base"] < ctx["align_peak"],
          f"streamed peak {main['peak_device_bytes_above_base']} >= resident {ctx['align_peak']}")
    check(main["codec"] == "b32" and main["chunks"] > 0, "the main streamed run is not b32 chunks")
    for kname, short in (("sw_cell16_kernel[exact]", "cell"), ("sw_row_kernel", "row"),
                         ("sw_col_kernel", "col"), ("sw_cell16_kernel[batch,exact]", "cell_batch"),
                         ("sw_col_flat_kernel", "col_flat")):
        kernels[kname]["stream_launches"] = counts[short][0]
    variants = [main]
    run, _, v = stream_align("hits_stream_noprefix.tsv", CUDASW4_TPU_TORCH_STREAM_RESIDENT="0")
    check(v._resident_chunks == [] and run["prefix_bytes"] == 0, "prefix off kept a prefix")
    variants.append(run)
    run, dpx_counts, v = stream_align("hits_stream_dpx.tsv", "--dpx")
    check(v.state16 and dpx_counts["cell_batch"][0] > 0, "--dpx did not stream its batch")
    variants.append(run)
    sw_col.COL_FUSE_MIN_S = 3
    try:
        run, fused_counts, _ = stream_align("hits_stream_fused.tsv")
    finally:
        sw_col.COL_FUSE_MIN_S = 0
    check(fused_counts["col_fused"][0] > 0, "the fused pass launched no B6")
    kernels["sw_col_fused_kernel"]["stream_launches"] = fused_counts["col_fused"][0]
    variants.append(run)
    run, _, v = stream_align("hits_stream_raw.tsv", CUDASW4_TPU_TORCH_STREAM_PACK="0")
    check(v._stream_pack is None and run["codec"] is None, "raw chunks were packed")
    variants.append(run)
    run, _, v = stream_align("hits_stream_b21.tsv", CUDASW4_TPU_TORCH_STREAM_PACK="2")
    check(run["codec"] == "b21", "b21 chunks were not b21")
    variants.append(run)
    for k in kernels.values():
        k.setdefault("stream_launches", 0)

    # Every streamed score of two queries against the resident engine's.
    db = load_db(sprefix)
    seng = SearchEngine(scoring=cfg, num_top=10, max_device_bytes=budget,
                        stream_chunk_bytes=parse_memory_string(STREAM_BATCH_BYTES))
    seng.set_database(db, pack_cache=store)
    check(seng.streaming and seng._stream_codec == "b32", "the streamed engine is not b32")
    n = db.num_sequences
    whole = {}
    for qlen in (464, 5478):
        codes = encode(next(q for q in queries if len(q) == qlen))
        got = torch.full((n,), -1.0, device="cuda")
        for rows, sidx in seng._stream_rows([codes]):
            ids = sidx.reshape(-1).long()
            keep = ids >= 0
            got[ids[keep]] = rows[0][keep]
        want = torch.full((n,), -1.0, device="cuda")
        want[res_eng._flat_idx[res_eng._valid]] = res_eng.slot_scores(codes)[res_eng._valid]
        check(bool((want >= 0).all()) and torch.equal(got, want),
              f"{qlen}-aa query: {int((got != want).sum())} streamed scores differ from resident")
        whole[qlen] = n

    # Streamed against resident, in turns, after one untimed pass each.
    cells = float(sum(len(q) for q in queries)) * res_eng.packed.total_real_chars
    turns = {"resident": [], "streamed": []}
    for who in ("resident", "streamed", "resident", "streamed", "streamed", "resident"):
        e = res_eng if who == "resident" else seng
        _, sec = wall(lambda: list(e.scan_many(queries)))
        turns[who].append(sec)
    turns = {k: v[1:] for k, v in turns.items()}
    pass_stats = seng.stream_copy_stats()
    single, single_stats = {}, {}
    for qlen in (144, 464):
        q = next(q for q in queries if len(q) == qlen)
        single[qlen] = {"resident": [], "streamed": []}
        for who in ("resident", "streamed", "streamed", "resident"):
            e = res_eng if who == "resident" else seng
            _, sec = wall(lambda: e.scan(q))
            single[qlen][who].append(sec)
        single_stats[qlen] = seng.stream_copy_stats()

    # The link: one 256 MiB page-locked -> device copy.
    host = torch.empty(256 << 20, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    link_ms = cuda_ms(lambda: dev.copy_(host, non_blocking=True), reps=5)
    del host, dev

    # The unpack per chunk: the largest streamed chunk (the L = 5632 col
    # tile) and a 16 MB cell chunk, both codecs.
    unpack = {}
    for b in (seng.packed.buckets[-1], max(seng.packed.buckets, key=lambda b: b.L if b.kernel == "cell" else 0)):
        ct = seng._chunk_tiles(b)
        tiles = np.ascontiguousarray(b.tiles[:ct])
        for codec in ("b32", "b21"):
            words = torch.as_tensor(pack5.CODECS[codec][2](tiles)).cuda()
            fn = pack5.CODECS[codec][3]
            got = fn(words, tuple(tiles.shape[1:]))
            check(np.array_equal(got.cpu().numpy(), tiles), f"{codec} unpack differs on the card")
            ms = cuda_ms(lambda: fn(words, tuple(tiles.shape[1:])), reps=10)
            unpack[f"{codec} {list(tiles.shape)}"] = {
                "ms": ms, "bytes_out": tiles.size, "bytes_in": words.numel() * 4,
                "out_gb_per_s": tiles.size / ms / 1e6}

    # The traces in a fresh process: in this one, after the phases before,
    # the profiler dropped device records (PERF.md §7).
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--stream-trace-child",
                          sprefix, store], capture_output=True, text=True, timeout=600, cwd=REPO)
    check(res.returncode == 0, f"the streamed trace child failed: {res.stderr[-2000:]}")
    traced = json.loads(res.stdout.strip().splitlines()[-1])
    profiled, profiled_single = traced["profiled_streamed_20"], traced["profiled_streamed_464"]

    # A projection, not a run: TREMBL_SEQUENCES with this length model
    # (every bucket's tiles scaled), 0.7 of this card's memory as the
    # budget, the prefix as the engine sizes it at the default chunk caps;
    # the rest crosses the link at this run's copy rate, and the 20
    # queries score at this run's resident rate.
    scale = TREMBL_SEQUENCES / db.num_sequences
    copy_gbps = pass_stats["bytes"] / pass_stats["copy_ms"] / 1e6
    big_budget = 0.7 * torch.cuda.get_device_properties(0).total_memory
    big_work = stream_work_bytes([(b.L, b.NS, b.kernel, math.ceil(b.num_tiles * scale))
                                  for b in seng.packed.buckets])[0]
    raw_streamed = scale * padded - min(big_budget - big_work, 0.85 * big_budget)
    wire = raw_streamed * pass_stats["bytes"] / (padded - main["prefix_tile_bytes"])
    compute_s = scale * min(turns["resident"])
    transfer_s = wire / (copy_gbps * 1e9)
    emit({
        "phase": "stream", "store_seconds": t_store, "store_bytes": store_bytes,
        "gpu_mem": STREAM_GPU_MEM, "batch_bytes": STREAM_BATCH_BYTES,
        "padded_db_bytes": padded, "prefix_bytes": main["prefix_bytes"],
        "prefix_tile_bytes": main["prefix_tile_bytes"], "work_bytes": main["work_bytes"],
        "prefix_budget": main["prefix_budget"], "streamed_share": share,
        "align_runs": variants, "resident_align_gcups": ctx["total_gcups"],
        "resident_align_peak_device_bytes": ctx["align_peak"],
        "whole_scores_equal": whole,
        "turns_20_queries_seconds": turns,
        "gcups_20_streamed": cells / min(turns["streamed"]) / 1e9,
        "gcups_20_resident": cells / min(turns["resident"]) / 1e9,
        "pass_20": pass_stats, "copy_gb_per_s": copy_gbps,
        "single_seconds": single, "single_pass": single_stats,
        "link_256mib_ms": link_ms, "link_gb_per_s": (256 << 20) / link_ms / 1e6,
        "unpack_per_chunk": unpack, "profiled_streamed_20": profiled,
        "profiled_streamed_464": profiled_single,
        "projection_trembl": {
            "note": "projection from this run's rates, not a run",
            "sequences": TREMBL_SEQUENCES, "scale": scale, "padded_bytes": scale * padded,
            "budget_bytes": big_budget, "work_bytes": big_work,
            "streamed_wire_bytes_per_pass": wire,
            "transfer_seconds_per_pass": transfer_s, "compute_seconds_20_queries": compute_s,
            "transfer_share_if_serial": transfer_s / (transfer_s + compute_s)},
        "seconds": time.perf_counter() - t_phase,
    })


# --------------------------------------------------------- phase mesh

#: The least share of the padded bytes that the streamed mesh streams.
MESH_STREAM_MIN_SHARE = 1 / 3


def mesh_devices() -> list[str]:
    """The mesh's two shards: two cards where there are two, else both on
    cuda:0."""
    return ["cuda:0", "cuda:1"] if torch.cuda.device_count() >= 2 else ["cuda:0", "cuda:0"]


def sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def mesh_wall(fn):
    """(result, seconds) of ``fn`` on the host clock, every card
    synchronised before and after."""
    sync_all()
    t0 = time.perf_counter()
    out = fn()
    sync_all()
    return out, time.perf_counter() - t0


def shard_ms(shard, fn, reps: int = 3) -> float:
    """Mean milliseconds of ``fn`` enqueued alone on one shard's stream
    (CUDA events on that stream, one warm-up call)."""
    from cudasw4_tpu_torch.parallel.sharding import shard_context

    with shard_context(shard):
        fn()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(shard.stream)
        for _ in range(reps):
            fn()
        stop.record(shard.stream)
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def hit_lines(text: str) -> list:
    """The lines run_multihost writes for its hits and its "Total" line,
    without anything else a process logs to its standard error."""
    return [line for line in text.splitlines()
            if line.startswith(("# ", "Total ")) or re.match(r"\d+\t", line)]


def run_multihost_processes(ctx, nproc: int, *extra):
    """``nproc`` processes of tools/run_multihost.py over phase 4's database
    and the 20 queries, meeting at a file store of their own (no port to
    choose); returns (each process's hit lines, rank 0's from its standard
    output and every other's from its standard error, without the timing
    line; each one's "Total" line; seconds).  Every process is waited for,
    and killed if the run passes its limit."""
    rendezvous = os.path.join(WORK, "mesh", f"rendezvous-{nproc}-{time.time_ns()}")
    cmd = [sys.executable, "-m", "cudasw4_tpu_torch.tools.run_multihost", "--db", ctx["prefix"],
           "--query", QUERY_SET, "--top", "10", "--coordinator", f"file://{rendezvous}",
           "--num-processes", str(nproc), "--packCache", ctx["prefix"] + "0.tpupack.npz", *extra]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd + ["--process-id", str(i)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=REPO, env=env)
             for i in range(nproc)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            check(p.returncode == 0, f"run_multihost failed ({' '.join(extra)}): {err[-2000:]}")
            outs.append(out.splitlines() if not outs else hit_lines(err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    for lines in outs:
        check(lines and lines[-1].startswith("Total "), "run_multihost printed no Total line")
    return [lines[:-1] for lines in outs], [lines[-1] for lines in outs], seconds


def phase_mesh(ctx, kernels):
    """The database sharded over a mesh of two shards (two cards, or both
    on one card): phase 4's database resident on the mesh, the 20 queries
    through scan_many (the batch of 14: B4, B5, B2 on each shard; 6
    singles: B1, B2, B3) with align's TSV writer, byte for byte phase 4's
    TSV; the 14 again with COL_FUSE_MIN_S = 3 (B6); int16 state (B1 and
    B3 int16) with the same TSV, and at SAT lowered to the median top
    score, so that tiles flag on both shards and go through the mesh
    re-score; the 10,625-aa query against phase long_query's hits; the
    mesh against the single device in turns; each shard's device time
    alone; the merge's time and the candidate bytes a scan exchanges;
    peak memory.  Then phase stream's database streamed on the mesh under
    a per-shard budget at which at least a third of the padded bytes
    stream: the TSV again, each card's peak within its shards' budgets,
    and all 573k scores of the 464-aa query against the resident engine's.
    Then tools/run_multihost.py as two processes on the mesh (gloo, one
    shard each) and as one under NCCL at world size 1 (two shards): every
    process prints the single device's hits."""
    from cudasw4_tpu_torch.cli.align import TSV_HEADER, parse_memory_string, print_scan_result_tsv
    from cudasw4_tpu_torch.constants import encode
    from cudasw4_tpu_torch.db.fasta import read_sequences
    from cudasw4_tpu_torch.engine import SearchEngine
    from cudasw4_tpu_torch.engine_streaming import stream_work_bytes
    from cudasw4_tpu_torch.ops import sw_cell, sw_col
    from cudasw4_tpu_torch.parallel.sharding import make_mesh, shard_context

    t_phase = time.perf_counter()
    d = os.path.join(WORK, "mesh")
    os.makedirs(d, exist_ok=True)
    with open(ctx["tsv"]) as f:
        exact_text = f.read()
    records = list(read_sequences(QUERY_SET))
    queries = [r.sequence for r in records]
    db, cfg, single = ctx["db"], ctx["cfg"], ctx["eng"]
    devices = mesh_devices()
    cards = sorted({torch.device(x).index for x in devices})
    layout = "two cards" if len(cards) == 2 else "two shards on one card"
    cells = float(sum(len(q) for q in queries)) * single.packed.total_real_chars

    def tsv_of(eng, name):
        """scan_many of the 20 on ``eng``, written as align writes its TSV."""
        path = os.path.join(d, name)
        with open(path, "w") as out:
            out.write(TSV_HEADER)
            for qi, (res, rec) in enumerate(zip(eng.scan_many(queries), records)):
                print_scan_result_tsv(out, res, eng, qi, len(rec.sequence), rec.header)
        with open(path) as f:
            return f.read()

    def peaks_reset():
        sync_all()
        base = {}
        for i in cards:
            torch.cuda.reset_peak_memory_stats(i)
            base[i] = torch.cuda.memory_allocated(i)
        return base

    def peaks_above(base):
        return {i: torch.cuda.max_memory_allocated(i) - base[i] for i in cards}

    # Resident on the mesh: the 20 queries through scan_many.
    eng = SearchEngine(scoring=cfg, num_top=10, mesh=make_mesh(devices))
    (_, t_set) = mesh_wall(lambda: eng.set_database(db, pack_cache=ctx["prefix"] + "0.tpupack.npz"))
    check(not eng.streaming, "the mesh streamed phase 4's database")
    shard_tiles = [[0 if t is None else int(t.shape[0]) for t in sh.tiles] for sh in eng._shards]
    check(all(sum(x) > 0 for x in shard_tiles), f"a shard holds no tile: {shard_tiles}")
    base = peaks_reset()
    reset_counts()
    text, t_align = mesh_wall(lambda: tsv_of(eng, "hits_mesh.tsv"))
    counts = read_counts()
    align_peaks = peaks_above(base)
    check(text == exact_text, "mesh scan_many: TSV differs from phase 4's")
    check_path(counts, "mesh align", ("cell", "row", "col", "cell_batch", "col_flat"))
    check(not any(counts[k][0] for k in ("cell16", "col16", "manual", "manual16", "pair")),
          "mesh align launched an int16 or tool kernel")

    # The batch of 14 with COL_FUSE_MIN_S = 3: B6 on each shard.
    qcap_b = eng._qcap_batch
    group_idx = [i for i, q in enumerate(queries) if len(q) <= qcap_b]
    group = [encode(queries[i]) for i in group_idx]
    check(len(group) == 14, f"a batch of {len(group)}, expected 14")
    hits = {}
    for line in exact_text.splitlines()[1:]:
        c = line.split("\t")
        hits.setdefault(int(c[0]), []).append((int(c[4]), int(c[7])))
    sw_col.COL_FUSE_MIN_S = 3
    try:
        reset_counts()
        fused = eng.scan_batch(group)
        fused_counts = read_counts()
    finally:
        sw_col.COL_FUSE_MIN_S = 0
    check(fused_counts["col_fused"][0] > 0, "the fused mesh batch launched no B6")
    check(all(v[1] == 0 for v in fused_counts.values()), "a plain version ran in the fused mesh batch")
    check([list(zip(r.scores, r.reference_ids)) for r in fused] == [hits[i] for i in group_idx],
          "fused mesh batch: hits differ from phase 4's")

    # int16 state on the mesh, then at a lowered SAT: the mesh re-score.
    eng.state16 = True
    reset_counts()
    check(tsv_of(eng, "hits_mesh_dpx.tsv") == exact_text, "mesh --dpx: TSV differs from the exact one")
    dpx_counts = read_counts()
    check_path(dpx_counts, "mesh --dpx", ("cell16", "row", "col16"))
    tops = sorted(h[0][0] for h in hits.values())
    sat_low = tops[len(tops) // 2]
    flagged, real_rescore = [], SearchEngine._rescore_overflow_mesh

    def spy(self, tmaxes, vals, ids, codes):
        flagged.append([sum(int((t >= sw_cell.SAT).sum()) for t in per) for per in tmaxes])
        return real_rescore(self, tmaxes, vals, ids, codes)

    default_sat = sw_cell.SAT
    SearchEngine._rescore_overflow_mesh, sw_cell.SAT = spy, sat_low
    try:
        reset_counts()
        low_text = tsv_of(eng, "hits_mesh_dpx_lowered_sat.tsv")
        low_counts = read_counts()
    finally:
        SearchEngine._rescore_overflow_mesh, sw_cell.SAT = real_rescore, default_sat
        eng.state16 = False
    check(low_text == exact_text, f"mesh --dpx at SAT={sat_low}: TSV differs from the exact one")
    check(any(all(n > 0 for n in per) for per in flagged),
          f"no query flagged tiles on both shards at SAT={sat_low}: {flagged}")
    check_path(low_counts, "mesh --dpx at a lowered SAT", ("cell16", "col16"))

    # The 10,625-aa query: B3's carry on each shard.
    long_codes, long_hits = ctx["long_query"]
    reset_counts()
    res, long_s = mesh_wall(lambda: eng.scan(long_codes))
    long_counts = read_counts()
    check(list(zip(res.scores, res.reference_ids)) == long_hits,
          "mesh long query: hits differ from phase long_query's")
    check_path(long_counts, "mesh long query", ("cell", "row", "col"))

    # The mesh against the single device, in turns.
    turns = {"single": [], "mesh": []}
    for who in ("single", "mesh", "mesh", "single"):
        e = single if who == "single" else eng
        _, sec = mesh_wall(lambda: list(e.scan_many(queries)))
        turns[who].append(sec)

    # Each shard's device time alone, the mesh's host-clock time for the
    # same work, and the single device's.
    mid = encode(next(q for q in queries if len(q) == QUERY_LADDER[1]))  # 464 aa
    per_shard = {
        "query_464": [shard_ms(sh, lambda sh=sh: eng._bucket_parts(sh.tiles, sh.device, mid, True,
                                                                   sh.matrix, sh.lengths))
                      for sh in eng._shards],
        "batch_14": [shard_ms(sh, lambda sh=sh: eng._batch_rows(sh.tiles, sh.device, group,
                                                                sh.matrix, sh.lengths), reps=1)
                     for sh in eng._shards],
    }
    mesh_ms = {
        "query_464": 1e3 * mesh_wall(lambda: eng._finish_single(mid, *eng._dispatch(mid)))[1],
        "batch_14": 1e3 * mesh_wall(lambda: eng._dispatch_batch_mesh(group).merged())[1],
    }
    single_ms = {
        "query_464": cuda_ms(lambda: single.slot_scores(mid), reps=1),
        "batch_14": cuda_ms(lambda: single.batch_slot_scores(group), reps=1),
    }
    cands = eng._dispatch_batch_mesh(group)
    host = cands.host()
    merge_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        cands.merged(host)
        merge_s.append(time.perf_counter() - t0)
    exchange_bytes = 2 * host[0].nbytes * eng.mesh.size // len(eng._shards)
    del cands, host, eng
    torch.cuda.empty_cache()

    # Streamed on the mesh: phase stream's store, a per-shard budget at
    # which a third or more of the padded bytes stream.
    chunk = parse_memory_string(STREAM_BATCH_BYTES)
    shapes = [(b.L, b.NS, b.kernel, b.num_tiles) for b in single.packed.buckets]
    padded = single.packed.total_padded_chars
    work = stream_work_bytes(shapes, chunk, None, SearchEngine.QB_STREAM, len(devices))[0]
    budget = work + padded // 4
    seng = SearchEngine(scoring=cfg, num_top=10, mesh=make_mesh(devices), max_device_bytes=budget,
                        stream_chunk_bytes=chunk)
    (_, t_sset) = mesh_wall(lambda: seng.set_database(db, pack_cache=ctx["stream_store"]))
    check(seng.streaming and seng._stream_codec == "b32", "the mesh did not stream b32 chunks")
    prefix_tiles = sum(seng._res_tiles.get(bi, 0) * b.L * b.NS
                       for bi, b in enumerate(seng.packed.buckets))
    share = 1.0 - prefix_tiles / padded
    check(share >= MESH_STREAM_MIN_SHARE, f"{share:.3f} of the padded bytes streamed on the mesh")
    base = peaks_reset()
    reset_counts()
    stext, t_salign = mesh_wall(lambda: tsv_of(seng, "hits_mesh_stream.tsv"))
    scounts = read_counts()
    speaks = peaks_above(base)
    check(stext == exact_text, "streamed mesh: TSV differs from phase 4's")
    check_path(scounts, "streamed mesh", ("cell", "row", "col", "cell_batch", "col_flat"))
    for i in cards:
        n_on = sum(1 for x in devices if torch.device(x).index == i)
        check(speaks[i] <= n_on * budget,
              f"streamed mesh: cuda:{i}'s peak {speaks[i]} B above base passes {n_on} x {budget} B")
    copy = seng.stream_copy_stats()
    n = db.num_sequences
    setups = []
    for sh in seng._shards:
        with shard_context(sh):
            setups.append(seng._stream_setup([mid], sh.device))
    got = torch.full((n,), -1.0, device=devices[0])
    sync_all()  # the shards' streams write it
    for b, parts in seng._scan_chunks_mesh():
        for sh, setup, part in zip(seng._shards, setups, parts):
            if part is None:
                continue
            with shard_context(sh):
                tiles, sidx, lens = part
                rows = seng._chunk_rows(tiles, b, [mid], setup, sh.matrix, lens)
                ids = sidx.reshape(-1).long()
                keep = ids >= 0
                got[ids[keep].to(devices[0])] = rows[0][keep].to(devices[0])
    sync_all()
    want = torch.full((n,), -1.0, device=devices[0])
    want[single._flat_idx[single._valid]] = single.slot_scores(mid)[single._valid].to(devices[0])
    check(bool((want >= 0).all()) and torch.equal(got, want),
          f"streamed mesh: {int((got != want).sum())} scores of the 464-aa query differ")
    del seng, got, want
    torch.cuda.empty_cache()

    # Processes: two over gloo (one shard each), and one under NCCL alone.
    want_lines = []
    for qi, rec in enumerate(records):
        want_lines.append(f"# {rec.header}")
        want_lines += ["\t".join(line.split("\t")[3:]) for line in exact_text.splitlines()[1:]
                       if int(line.split("\t")[0]) == qi]
    runs = {}
    for name, nproc, extra in (("gloo_two_processes", 2, ("--backend", "gloo", "--shards", "1")),
                               ("nccl_one_process", 1, ("--backend", "nccl", "--shards", "2"))):
        outs, totals, seconds = run_multihost_processes(ctx, nproc, *extra)
        check(all(o == want_lines for o in outs), f"run_multihost ({name}): lines differ from phase 4's")
        runs[name] = {"backend": extra[1], "processes": nproc, "shards_per_process": int(extra[3]),
                      "seconds": seconds, "totals": totals}

    kernels_mesh = {"sw_cell16_kernel[exact]": counts["cell"][0], "sw_row_kernel": counts["row"][0],
                    "sw_col_kernel": counts["col"][0],
                    "sw_cell16_kernel[batch,exact]": counts["cell_batch"][0],
                    "sw_col_flat_kernel": counts["col_flat"][0],
                    "sw_col_fused_kernel": fused_counts["col_fused"][0],
                    "sw_cell16_kernel": dpx_counts["cell16"][0], "sw_col16_kernel": dpx_counts["col16"][0]}
    for name, k in kernels.items():
        k["mesh_launches"] = kernels_mesh.get(name, 0)
        check(k["mesh_launches"] > 0 or k["path"] not in MESH_PATHS, f"{name}: no launch on the mesh")
    emit({
        "phase": "mesh", "layout": layout, "devices": devices, "shard_tiles": shard_tiles,
        "set_database_seconds": t_set, "align_seconds": t_align,
        "tsv_equal": ["resident", "dpx", "dpx_lowered_sat", "streamed"],
        "launches": {k: v[0] for k, v in counts.items()},
        "fused_launches": {k: v[0] for k, v in fused_counts.items()},
        "dpx_launches": {k: v[0] for k, v in dpx_counts.items()},
        "lowered_sat": sat_low, "lowered_sat_flagged_per_shard": flagged,
        "lowered_sat_launches": {k: v[0] for k, v in low_counts.items()},
        "long_query_seconds": long_s,
        "turns_20_queries_seconds": turns,
        "gcups_20_mesh": cells / min(turns["mesh"]) / 1e9,
        "gcups_20_single": cells / min(turns["single"]) / 1e9,
        "per_shard_device_ms": per_shard, "mesh_host_ms": mesh_ms, "single_device_ms": single_ms,
        "merge_ms_batch14": [1e3 * x for x in merge_s],
        "exchange_bytes_batch14": exchange_bytes,
        "align_peak_device_bytes_above_base": align_peaks,
        "stream": {"budget_per_shard": budget, "work_per_shard": work, "streamed_share": share,
                   "prefix_bytes_per_shard": prefix_tiles // len(devices),
                   "set_database_seconds": t_sset, "align_seconds": t_salign,
                   "gcups_20": cells / t_salign / 1e9,
                   "peak_device_bytes_above_base": speaks, **copy,
                   "launches": {k: v[0] for k, v in scounts.items()},
                   "whole_scores_equal_464": n},
        "processes": runs,
        "seconds": time.perf_counter() - t_phase,
    })


# --------------------------------------------------------- phase tools

#: Phase tools' sizes of the engine tools: bigsingle's T (a quarter of
#: the JAX tool's 64) and reps, sweepdiag's L and nseq (cut from 1M to
#: 200k, about phase 4's residues), tremblbench's scale (N = 20M / 20).
BIGSINGLE_ARGS = (16, 3)
SWEEPDIAG_ARGS = (1024, 200_000)
TREMBL_SCALE = 20


def captured(fn, *args, **kw):
    """(fn's result, its stdout lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue().splitlines()


def phase_tools(kernels):
    """dmabench and pairbench in this process at their defaults: every
    checked line must say OK; their counters are B7's and B8's launches.
    Then the engine tools, each with its counters reset just before it:
    bigsingle at BIGSINGLE_ARGS (B1 against B3 on the same cell tiles in
    both states, every line OK), sweepdiag at SWEEPDIAG_ARGS (20 query
    lines and the total), and tremblbench at TREMBL_SCALE: streamed, its
    14 queries' hits equal to a resident engine's on the same database."""
    from cudasw4_tpu_torch.engine import SearchEngine
    from cudasw4_tpu_torch.tools import bigsingle, dmabench, pairbench, sweepdiag, tremblbench

    t_phase = time.perf_counter()
    reset_counts()
    lines = {}
    for tool in (dmabench, pairbench):
        rc, lines[tool.__name__.rsplit(".", 1)[1]] = captured(tool.main, [])
        check(rc == 0, f"{tool.__name__} failed")
    counts = read_counts()
    checked = [x for ls in lines.values() for x in ls if "[" in x]
    check(len(checked) == 7 and all(x.endswith("[OK]") for x in checked),
          f"the tools' checks: {checked}")
    check_path(counts, "dmabench and pairbench", ("cell", "manual", "pair"))
    kernels["sw_manual_kernel"]["launches"] = counts["manual"][0]
    kernels["sw_pair_kernel"]["launches"] = counts["pair"][0]
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    reset_counts()
    big, lines["bigsingle"] = captured(bigsingle.run, *BIGSINGLE_ARGS, dev)
    big_counts = read_counts()
    n_lines = len(bigsingle.LENGTHS) * len(bigsingle.QUERY_LENGTHS) * 2
    check(len(big) == n_lines and all(x["ok"] for x in big),
          f"bigsingle: {[x for x in lines['bigsingle'] if 'OK' not in x]}")
    check_path(big_counts, "bigsingle", ("cell", "cell16", "col", "col16"))
    t_big = time.perf_counter() - t0

    t0 = time.perf_counter()
    reset_counts()
    sweep, lines["sweepdiag"] = captured(sweepdiag.run, *SWEEPDIAG_ARGS, dev)
    sweep_counts = read_counts()
    check(len(sweep["queries"]) == 20 and all(q["gcups"] > 0 for q in sweep["queries"]),
          f"sweepdiag: {lines['sweepdiag']}")
    check_path(sweep_counts, "sweepdiag", ("col", "col_flat"))
    t_sweep = time.perf_counter() - t0

    t0 = time.perf_counter()
    store = os.path.join(WORK, "trembl", "store")
    reset_counts()
    trembl, lines["tremblbench"] = captured(
        tremblbench.run, int(tremblbench.N / TREMBL_SCALE), 1,
        int(tremblbench.BUDGET / TREMBL_SCALE), store, dev, TREMBL_SCALE)
    trembl_counts = read_counts()
    check_path(trembl_counts, "tremblbench", ("cell_batch", "col_flat"))
    resident = SearchEngine(num_top=10)
    resident.set_database(trembl["db"], pack_cache=store)
    check(not resident.streaming, "the resident engine streamed tremblbench's database")
    want = [(r.scores, r.reference_ids) for r in resident.scan_many(trembl["queries"])]
    check([(r.scores, r.reference_ids) for r in trembl["results"]] == want,
          "tremblbench: streamed hits differ from the resident engine's")
    del resident
    t_trembl = time.perf_counter() - t0
    emit({"phase": "tools", "lines": lines, "launches": {k: v[0] for k, v in counts.items()},
          "bigsingle": {"args": list(BIGSINGLE_ARGS), "lines": big, "seconds": t_big,
                        "launches": {k: v[0] for k, v in big_counts.items()}},
          "sweepdiag": {"args": list(SWEEPDIAG_ARGS), **sweep, "seconds": t_sweep,
                        "launches": {k: v[0] for k, v in sweep_counts.items()}},
          "tremblbench": {"scale": TREMBL_SCALE, "sequences": trembl["db"].num_sequences,
                          "residues": trembl["residues"], "budget": int(tremblbench.BUDGET
                                                                       / TREMBL_SCALE),
                          "chunk_bytes": trembl["chunk_bytes"], "work_bytes": trembl["work_bytes"],
                          "set_database_s": trembl["set_database_s"],
                          "first_pass_s": trembl["first_pass_s"], "passes": trembl["passes"],
                          "copy": trembl["copy"], "peak_device_bytes": trembl["peak_device_bytes"],
                          "hits_equal_resident": True, "seconds": t_trembl,
                          "launches": {k: v[0] for k, v in trembl_counts.items()}},
          "seconds": time.perf_counter() - t_phase})


# -------------------------------------------------- phase colstate16

#: The colstate16 phase's arguments: T = 16 tiles (a quarter of the JAX
#: tool's default 64), 3 timed calls after the warm-up.
COLSTATE16_ARGS = ("16", "3")
#: The colstate16 line whose B5 int16 call the kernels line times and holds
#: whole against the plain version: the flat line with the fewest cells.
COLSTATE16_ROW = {"kind": "flat", "L": 1024, "rows": [1024, 1024]}


def stream_trace_child(prefix: str, store: str) -> int:
    """Phase stream's traces in a fresh process (``chip_smoke.py
    --stream-trace-child PREFIX STORE``): phase stream's streamed engine
    on the database ``prefix`` and its tile store, one untraced pass of the
    20 queries, then ``device_idle_share`` of a pass of the 20 and of the
    464-aa query alone.  Prints {"profiled_streamed_20",
    "profiled_streamed_464"} as the last line."""
    from cudasw4_tpu_torch import make_scoring_config
    from cudasw4_tpu_torch.cli.align import parse_memory_string
    from cudasw4_tpu_torch.db.format import load_db
    from cudasw4_tpu_torch.engine import SearchEngine

    seng = SearchEngine(scoring=make_scoring_config("blosum62"), num_top=10,
                        max_device_bytes=parse_memory_string(STREAM_GPU_MEM),
                        stream_chunk_bytes=parse_memory_string(STREAM_BATCH_BYTES))
    seng.set_database(load_db(prefix), pack_cache=store)
    check(seng.streaming, "the trace child's engine does not stream")
    queries = [seq for _, seq in read_query_set()]
    mid = next(q for q in queries if len(q) == 464)
    list(seng.scan_many(queries))
    emit({"profiled_streamed_20": device_idle_share(lambda: list(seng.scan_many(queries)),
                                                    "stream_trace.json"),
          "profiled_streamed_464": device_idle_share(lambda: seng.scan(mid),
                                                     "stream_464_trace.json")})
    return 0


def colstate16_child(argv) -> int:
    """The tool in this process, its counters reset just before it and
    read just after.  Each line's int16 scores are held against the plain
    version on the card on the same inputs (the plain versions count no
    launch): the first tile of every line, and every tile of
    COLSTATE16_ROW's line, timed.  Prints {"counts", "held", "row"} as the
    last line."""
    from cudasw4_tpu_torch.ops import cuda_lib, sw_col
    from cudasw4_tpu_torch.tools import colstate16

    held, row = [], {}

    def inspect(line, inputs, scores):
        tiles, q, mat, params = (inputs[k] for k in ("tiles", "queries", "matrix", "params"))
        whole = all(line[k] == v for k, v in COLSTATE16_ROW.items())
        n = tiles.shape[0] if whole else 1
        if line["kind"] == "single":
            got = scores["i16"][:n]
            want, pms = timed(lambda: sw_col.score_bucket_col_plain(tiles[:n], q, mat, params,
                                                                   exact=False))
        else:
            got = scores["i16"][:, :n]
            want, pms = timed(lambda: sw_col.score_bucket_col_flat_plain(tiles[:n], q, mat,
                                                                        params, exact=False))
        err = float((got - want).abs().max())
        held.append({"kind": line["kind"], "L": line["L"], "rows": line["rows"], "tiles": n,
                     "max_abs_err": err})
        if whole:
            T, L = tiles.shape[:2]
            row.update(shape=list(tiles.shape), nq=sum(params[4:]), real_rows=sum(line["rows"]),
                       slots=len(line["rows"]), ms=line["ms_i16"], plain_ms=pms,
                       pass_offsets=list(inputs["offs"]), rtot=inputs["rtot"],
                       boundary_bytes=cuda_lib.col_boundary_bytes(T, inputs["rtot"], 1))

    reset_counts()
    rc = colstate16.main(argv, inspect=inspect)
    emit({"counts": read_counts(), "held": held, "row": row})
    return rc


def phase_colstate16(kernels, clock_mhz):
    """The ported tools/colstate16.py in a fresh process at COLSTATE16_ARGS:
    B3 and B5 in int32 and int16 state at L = 1024 and 2048, every line OK
    (the modes agree under the SAT rule), every line's int16 scores equal
    to the plain version's (the first tile; every tile of COLSTATE16_ROW's
    line).  Its counters are B5 int16's launches, and the kernels line's
    B5 int16 figures become those of COLSTATE16_ROW's call (phase sprot's,
    at the align shape, move under "align_shape")."""
    t_phase = time.perf_counter()
    res = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--colstate16-child", *COLSTATE16_ARGS],
        capture_output=True, text=True, cwd=REPO, timeout=600,
    )
    out = res.stdout.splitlines()
    check(res.returncode == 0 and out, f"colstate16 exited {res.returncode}:\n{res.stderr[-3000:]}")
    lines = [x for x in out if x.startswith(("single", "flat"))]
    check(len(lines) == 10 and all(x.endswith("[OK]") for x in lines), f"colstate16's lines: {lines}")
    child = json.loads(out[-1])
    counts, held, got = child["counts"], child["held"], child["row"]
    check_path(counts, "colstate16", ("col", "col16", "col_flat", "col_flat16"))
    check(len(held) == 10 and all(h["max_abs_err"] == 0.0 for h in held),
          f"colstate16: int16 scores against the plain version: {held}")
    check(bool(got), f"colstate16 ran no line {COLSTATE16_ROW}")

    row = kernels["sw_col_flat16_kernel"]
    row["align_shape"] = {k: row.pop(k) for k in (
        "shape", "nq", "slots", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
        "cells_real", "cells_padded", "gcups_real", "gcups_padded", "pass_offsets",
        "boundary_bytes")}
    shape, nq, slots = got["shape"], got["nq"], got["slots"]
    real = got["real_rows"] * int(np.prod(shape))  # every subject is L residues
    nbytes = int(np.prod(shape)) + 4 * nq + 4 * slots * shape[0] * int(np.prod(shape[2:]))
    b_ms, by = bound(real, nbytes, clock_mhz, "s16x2")
    row.update(
        launches=counts["col_flat16"][0], shape=shape, nq=nq, slots=slots, ms=got["ms"],
        plain_ms=got["plain_ms"], bound_ms=b_ms, bound_by=by,
        max_abs_err=max(h["max_abs_err"] for h in held if h["kind"] == "flat"),
        cells_real=real, cells_padded=nq * int(np.prod(shape)), gcups_real=real / got["ms"] / 1e6,
        gcups_padded=nq * int(np.prod(shape)) / got["ms"] / 1e6, pass_offsets=got["pass_offsets"],
        rtot=got["rtot"], boundary_bytes=got["boundary_bytes"], colstate16_line=COLSTATE16_ROW)
    gcups = [dict(zip(("i32", "i16"), map(float, re.findall(r"([\d.]+) GCUPS", x)))) for x in lines]
    emit({"phase": "colstate16", "args": list(COLSTATE16_ARGS), "lines": lines,
          "gcups": [{"line": x.split(":")[0], **g} for x, g in zip(lines, gcups)],
          "held_against_plain": held, "launches": {k: v[0] for k, v in counts.items()},
          "seconds": time.perf_counter() - t_phase})


# ------------------------------------------------------- phase build

def phase_build():
    """The kernel library built from an empty object directory (its units
    in parallel, ``cuda_lib.build``), every exported launcher present, its
    (G, R) table the Python one's."""
    import ctypes
    import shutil

    from cudasw4_tpu_torch.ops import cuda_lib, sw_cell

    t_phase = time.perf_counter()
    lib_path = cuda_lib.library_path()
    shutil.rmtree(cuda_lib.object_dir(), ignore_errors=True)
    if lib_path.exists():
        lib_path.unlink()
    t0 = time.perf_counter()
    cuda_lib.build()
    t_build = time.perf_counter() - t0
    handle = ctypes.CDLL(str(lib_path))
    names = sorted({*cuda_lib.LAUNCHES.values(), *cuda_lib.CELL_LAUNCHES.values(),
                    *cuda_lib.COL_LAUNCHES.values(), *cuda_lib.TOOL_LAUNCHES.values(),
                    "sw_col_pass_columns", "sw_cell_shapes", "sw_error_string"})
    missing = [n for n in names if not hasattr(handle, n)]
    check(not missing, f"the kernel library lacks {missing}")
    t0 = time.perf_counter()
    cuda_lib.lib()
    t_load = time.perf_counter() - t0
    check(cuda_lib.cell_shapes() == list(sw_cell.CELL_SHAPES),
          "the library's (G, R) instances differ from sw_cell.CELL_SHAPES")
    emit({"phase": "build", "build_seconds": t_build, "load_seconds": t_load,
          "nproc": os.cpu_count(), "units": len(cuda_lib.UNITS),
          "jobs": cuda_lib.build_jobs(), "launchers_checked": len(names),
          "library": lib_path.name, "seconds": time.perf_counter() - t_phase})


# ------------------------------------------------------ phase warmup

#: The warmup phase's queries: the reference set's 144-aa and 464-aa ones.
WARMUP_QUERY_LENGTHS = (144, 464)


def warmup_child(prefix: str, qfile: str, warm: str, out_tsv: str, budget: str) -> int:
    """One fresh process of phase warmup (``chip_smoke.py --warmup-child``):
    the database at ``prefix`` (its tile store beside it) on an engine of
    ``budget`` ("-": resident), ``warmup()`` timed when ``warm`` is "1",
    then each query of ``qfile`` alone (host clock around ``scan``, which
    synchronises, and its own seconds), the hits written as align's TSV to
    ``out_tsv``, then on a resident database the queries as one batch,
    twice.  Prints one JSON line."""
    from cudasw4_tpu_torch.cli.align import TSV_HEADER, parse_memory_string, print_scan_result_tsv
    from cudasw4_tpu_torch.db.fasta import read_sequences
    from cudasw4_tpu_torch.db.format import load_db
    from cudasw4_tpu_torch.engine import SearchEngine

    t0 = time.perf_counter()
    extra = {}
    if budget != "-":
        extra = {"max_device_bytes": parse_memory_string(budget),
                 "stream_chunk_bytes": parse_memory_string(STREAM_BATCH_BYTES)}
    eng = SearchEngine(num_top=10, **extra)
    eng.set_database(load_db(prefix), pack_cache=prefix + "0.tpupack.npz")
    torch.cuda.synchronize()
    out = {"streaming": eng.streaming, "set_database_seconds": time.perf_counter() - t0}
    if warm == "1":
        t0 = time.perf_counter()
        out["warmup_launches"] = eng.warmup()
        out["warmup_seconds"] = time.perf_counter() - t0
    records = list(read_sequences(qfile))
    out["queries"] = []
    with open(out_tsv, "w") as f:
        f.write(TSV_HEADER)
        for i, rec in enumerate(records):
            t0 = time.perf_counter()
            res = eng.scan(rec.sequence)
            out["queries"].append({"aa": len(rec.sequence), "wall_s": time.perf_counter() - t0,
                                   "scan_s": res.stats.seconds})
            print_scan_result_tsv(f, res, eng, i, len(rec.sequence), rec.header)
    if not eng.streaming:
        out["batch_wall_s"] = []
        for _ in range(2):
            t0 = time.perf_counter()
            eng.scan_batch([rec.sequence for rec in records])
            out["batch_wall_s"].append(time.perf_counter() - t0)
    print(json.dumps(out), flush=True)
    return 0


def phase_warmup(ctx):
    """Fresh processes search phase 4's database for the 144-aa query, then
    the 464-aa one, each alone: one process with ``warmup()`` and one
    without (each query's seconds, the warmup's seconds and launches, and
    the first batch's extra time over its second, which warmup leaves
    cold), and one streamed under phase stream's budget with its one-scan
    warmup; the three write the same hits."""
    t_phase = time.perf_counter()
    d = os.path.join(WORK, "warmup")
    os.makedirs(d, exist_ok=True)
    qfile = os.path.join(d, "q.fa")
    with open(qfile, "w") as f:
        for n in WARMUP_QUERY_LENGTHS:
            header, seq = [q for q in read_query_set() if len(q[1]) == n][0]
            f.write(f">{header}\n{seq}\n")
    stream_prefix = ctx["stream_store"][: -len("0.tpupack.npz")]
    runs = {}
    for name, prefix, warm, budget in (("cold", ctx["prefix"], "0", "-"),
                                       ("warm", ctx["prefix"], "1", "-"),
                                       ("streamed_warm", stream_prefix, "1", STREAM_GPU_MEM)):
        tsv = os.path.join(d, f"{name}.tsv")
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--warmup-child", prefix,
                              qfile, warm, tsv, budget], capture_output=True, text=True,
                             timeout=900, cwd=REPO)
        check(res.returncode == 0, f"warmup child {name} failed: {res.stderr[-2000:]}")
        runs[name] = {**json.loads(res.stdout.strip().splitlines()[-1]),
                      "process_seconds": time.perf_counter() - t0}
        with open(tsv) as f:
            runs[name]["tsv"] = f.read()
    tsvs = {r.pop("tsv") for r in runs.values()}
    check(len(tsvs) == 1, "warmup changed the hits: the processes' TSVs differ")
    check(runs["warm"]["warmup_launches"] > 0, "warmup launched no kernel")
    check(runs["streamed_warm"]["streaming"], "the streamed warmup process did not stream")
    first = {n: r["queries"][0]["wall_s"] for n, r in runs.items()}
    second = {n: r["queries"][1]["wall_s"] for n, r in runs.items()}
    emit({"phase": "warmup", "runs": runs, "first_query_wall_s": first,
          "second_query_wall_s": second,
          "first_batch_extra_s": {n: r["batch_wall_s"][0] - r["batch_wall_s"][1]
                                  for n, r in runs.items() if "batch_wall_s" in r},
          "tsv_equal": True, "seconds": time.perf_counter() - t_phase})


# ------------------------------------------------------ phase tuning

def tuning_state() -> dict:
    """The tunable geometry as it stands: the layout chooser's ratios,
    CELL_MAX_L and the col kernels' NQC and LC."""
    from cudasw4_tpu_torch.db import packing
    from cudasw4_tpu_torch.ops import sw_col

    return {"cell_speedup": packing.CELL_SPEEDUP, "col_speedup": packing.COL_SPEEDUP,
            "cell_max_l": packing.CELL_MAX_L, "col_nqc": sw_col.NQC, "col_lc": sw_col.LC}


def set_tuning(state: dict) -> None:
    from cudasw4_tpu_torch.db import packing
    from cudasw4_tpu_torch.ops import sw_col

    packing.CELL_SPEEDUP, packing.COL_SPEEDUP = state["cell_speedup"], state["col_speedup"]
    packing.CELL_MAX_L = state["cell_max_l"]
    sw_col.NQC, sw_col.LC = state["col_nqc"], state["col_lc"]


def packaged_tuning() -> str | None:
    """The packaged tuning config whose platform is this card, if any."""
    from cudasw4_tpu_torch.db import packing

    for name in sorted(os.listdir(packing.TUNING_DIR)):
        if name.endswith(".json"):
            with open(os.path.join(packing.TUNING_DIR, name)) as f:
                if json.load(f).get("platform") == torch.cuda.get_device_name(0):
                    return os.path.join("cudasw4_tpu_torch", "tuning", name)
    return None


def phase_tuning(ctx, defaults):
    """gridsearch at the JAX package's defaults (lengths 128-2048, query
    length 512, 32M residues) with the col geometry sweep, its config
    emitted for this card; phase 4's database packed under the library
    defaults and under the config (the bucket plans by kind), the 20
    queries timed in turns (default, tuned, tuned, default) after one
    untimed pass each, in exact state and in int16 state (align --dpx's
    singles), and the TSV under the config byte for byte phase 4's in
    both.  The geometry is restored afterwards."""
    from cudasw4_tpu_torch.cli import gridsearch
    from cudasw4_tpu_torch.cli.align import TSV_HEADER, print_scan_result_tsv
    from cudasw4_tpu_torch.db import packing
    from cudasw4_tpu_torch.db.fasta import read_sequences
    from cudasw4_tpu_torch.engine import SearchEngine

    t_phase = time.perf_counter()
    d = os.path.join(WORK, "tuning")
    os.makedirs(d, exist_ok=True)
    entry = tuning_state()
    sweep_tsv, cfg_path = os.path.join(d, "sweep.tsv"), os.path.join(d, "tuning.json")
    t0 = time.perf_counter()
    rc, out = run_cli(gridsearch, ["--of", sweep_tsv, "--emit-config", cfg_path,
                                   "--nqcs", "2048,3072,4096", "--lcs", "128,256"])
    t_sweep = time.perf_counter() - t0
    check(rc == 0 and os.path.exists(cfg_path), f"gridsearch failed: {out[-500:]}")
    with open(cfg_path) as f:
        tuned_cfg = json.load(f)
    check(tuned_cfg["platform"] == torch.cuda.get_device_name(0), "config platform is not the card")
    with open(sweep_tsv) as f:
        sweep = [line.rstrip("\n").split("\t") for line in f][1:]
    geometry = [line.strip() for line in out.splitlines() if line.strip().startswith("col NQC=")]
    set_tuning(defaults)
    packing.apply_tuning(tuned_cfg)
    tuned = tuning_state()
    engines, plans = {}, {}
    for name, state in (("default", defaults), ("tuned", tuned)):
        set_tuning(state)
        eng = SearchEngine(scoring=ctx["cfg"], num_top=10)
        eng.set_database(ctx["db"])
        engines[name] = eng
        by_kind = {}
        for b in eng.packed.buckets:
            k = by_kind.setdefault(b.kernel, {"buckets": 0, "tiles": 0, "padded_chars": 0})
            k["buckets"] += 1
            k["tiles"] += b.num_tiles
            k["padded_chars"] += int(b.tiles.size)
        plans[name] = {"by_kind": by_kind, "buckets": [(b.kernel, b.L, b.num_tiles)
                                                       for b in eng.packed.buckets]}
    queries = ctx["queries"]
    cells = float(sum(len(q) for q in queries)) * ctx["db"].num_chars

    def search(name):
        set_tuning(defaults if name == "default" else tuned)
        results = list(engines[name].scan_many(queries))
        torch.cuda.synchronize()
        return results

    with open(ctx["tsv"]) as f:
        exact_text = f.read()
    turns = {}
    for mode in ("int32", "int16"):  # exact state, then align --dpx's singles
        for eng in engines.values():
            eng.state16 = mode == "int16"
        results = {name: search(name) for name in engines}  # the untimed passes
        turns[mode] = []
        for name in ("default", "tuned", "tuned", "default"):
            _, sec = wall(lambda name=name: search(name))
            turns[mode].append({"config": name, "seconds": sec, "gcups": cells / 1e9 / sec})
        buf = io.StringIO()
        buf.write(TSV_HEADER)
        for i, (rec, res) in enumerate(zip(read_sequences(QUERY_SET), results["tuned"])):
            print_scan_result_tsv(buf, res, engines["tuned"], i, len(rec.sequence), rec.header)
        check(buf.getvalue() == exact_text,
              f"the TSV under the tuned config ({mode}) differs from phase 4's")
    set_tuning(entry)
    del engines
    torch.cuda.empty_cache()
    summary = {}
    for mode, ts in turns.items():
        secs = {n: [t["seconds"] for t in ts if t["config"] == n] for n in ("default", "tuned")}
        summary[mode] = {
            "tuned_minus_default_s": sum(secs["tuned"]) / 2 - sum(secs["default"]) / 2,
            "spread_s": max(abs(secs["default"][0] - secs["default"][1]),
                            abs(secs["tuned"][0] - secs["tuned"][1]))}
    emit({"phase": "tuning", "auto_applied": packaged_tuning(), "emitted": tuned_cfg,
          "sweep_rows": sweep, "col_geometry": geometry, "sweep_seconds": t_sweep,
          "defaults": defaults, "tuned": tuned, "plans": plans, "turns": turns,
          "summary": summary, "tsv_equal": True, "seconds": time.perf_counter() - t_phase})


# ------------------------------------------------------ phase native

def phase_native(ctx):
    """The native IO library loaded; makedb of phase 4's FASTA with it and
    with CUDASW4_TPU_TORCH_NATIVE=0, the files byte for byte equal;
    pack_db both ways, the tiles equal; modifydb verify on the database."""
    from cudasw4_tpu_torch import native
    from cudasw4_tpu_torch.cli import makedb, modifydb
    from cudasw4_tpu_torch.db import packing

    t_phase = time.perf_counter()
    check(native.get_lib() is not None, f"the native library did not load: {native.build_error}")
    d = os.path.join(WORK, "native")
    os.makedirs(d, exist_ok=True)
    out = {}
    for name, env in (("native", "1"), ("python", "0")):
        with environ(CUDASW4_TPU_TORCH_NATIVE=env):
            t0 = time.perf_counter()
            rc, _ = run_cli(makedb, [ctx["fasta"], os.path.join(d, name)])
            out[f"makedb_{name}_seconds"] = time.perf_counter() - t0
            check(rc == 0, f"makedb ({name}) failed")
    files = ["metadata", "0chars", "0offsets", "0lengths", "0headers", "0headeroffsets",
             "0metadata"]
    for f in files:
        with open(os.path.join(d, "native" + f), "rb") as a, open(os.path.join(d, "python" + f),
                                                                 "rb") as b:
            check(a.read() == b.read(), f"makedb {f} differs with and without the native library")
    packs = {}
    for name, env in (("native", "1"), ("python", "0")):
        with environ(CUDASW4_TPU_TORCH_NATIVE=env):
            t0 = time.perf_counter()
            packs[name] = packing.pack_db(ctx["db"])
            out[f"pack_db_{name}_seconds"] = time.perf_counter() - t0
    for a, b in zip(packs["native"].buckets, packs["python"].buckets, strict=True):
        check(np.array_equal(a.tiles, b.tiles) and np.array_equal(a.seq_index, b.seq_index)
              and np.array_equal(a.lengths, b.lengths), f"pack_db bucket L={a.L} differs natively")
    del packs
    rc, text = run_cli(modifydb, ["verify", ctx["prefix"]])
    check(rc == 0 and text.startswith("OK:"), f"modifydb verify failed: {text[-300:]}")
    emit({"phase": "native", "library": str(native.library_path().name), **out,
          "files_equal": files, "verify": text.strip(), "seconds": time.perf_counter() - t_phase})


# ------------------------------------------------------ phase profile

#: What phase profile's trace must name: the batch's kernels (the row
#: kernel on either route) and the engine's spans.
PROFILE_KERNELS = ("sw_cell16_kernel", "sw_col_flat_kernel", "sw_row(_col)?_kernel")
PROFILE_SPANS = ("sw:scan_batch", "sw:batch_bucket cell", "sw:batch_bucket col")


def phase_profile(ctx):
    """align --profile DIR on the 144-aa and 464-aa queries (one batch), in
    a fresh process as a user runs it: the Chrome trace exists and names
    the batch's kernels and the engine's spans.  (Run in this process
    after the phases before it, the trace lacked the batch's first
    kernels: the profiler drops device records in this long process, see
    PERF.md §7.)"""
    t_phase = time.perf_counter()
    trace_dir = os.path.join(WORK, "profile")
    if os.path.exists(os.path.join(trace_dir, "trace.json")):
        os.remove(os.path.join(trace_dir, "trace.json"))
    res = subprocess.run([sys.executable, "-m", "cudasw4_tpu_torch.cli.align", "--query",
                          os.path.join(WORK, "warmup", "q.fa"), "--db", ctx["prefix"], "--top",
                          "10", "--tsv", "--profile", trace_dir], capture_output=True, text=True,
                         timeout=600, cwd=REPO)
    check(res.returncode == 0, f"align --profile failed: {res.stderr[-2000:]}")
    path = os.path.join(trace_dir, "trace.json")
    check(os.path.exists(path), "align --profile wrote no trace")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    kernels = {k: sum(1 for n in names if re.search(k, n)) for k in PROFILE_KERNELS}
    spans = {k: sum(1 for n in names if n.startswith(k)) for k in PROFILE_SPANS}
    check(all(kernels.values()), f"the trace lacks a kernel: {kernels}")
    check(all(spans.values()), f"the trace lacks a span: {spans}")
    emit({"phase": "profile", "trace": os.path.relpath(path, REPO),
          "trace_bytes": os.path.getsize(path), "kernels": kernels, "spans": spans,
          "seconds": time.perf_counter() - t_phase})



# --------------------------------------------------------------- phase bench

#: Phase bench's cut of the benchmark protocol (python -m
#: cudasw4_tpu_torch.bench): BENCH_NUM_SEQS from 1M (sweep) and 500k (peak)
#: to 100k, one rep; the pseudo databases of the hit check; the CLI's
#: config, runpeakbenchmark.sh's L = 1024 one at 100k sequences; and
#: dbbench's sequences and reps (its defaults).
BENCH_ENV = {"BENCH_NUM_SEQS": "100000", "BENCH_REPS": "1"}
BENCH_HIT_SEQS = 8192
BENCH_CLI_PSEUDO = (100_000, 1024)
DBBENCH_ARGS = (200_000, 2)
BENCH_L_LINE = re.compile(r"^# L=(\d+): ([0-9.]+) GCUPS \(([0-9.]+)s\)$")
BENCH_REP_LINE = re.compile(r"^# rep (\d+) at (\d+): ([0-9.]+)s ([0-9.]+) GCUPS$")
BENCH_RESIDENT_LINE = re.compile(r"^# resident (\d+) x (\d+): tiles (\d+) B, peak device memory (\d+) B$")
#: The kernels-line rows that the benchmark's launch counters stand for.
BENCH_COUNTERS = {
    "sw_cell16_kernel[exact]": "cell", "sw_cell16_kernel": "cell16", "sw_row_kernel": "row",
    "sw_col_kernel": "col", "sw_col16_kernel": "col16",
    "sw_cell16_kernel[batch,exact]": "cell_batch",
    "sw_cell16_kernel[batch]": "cell_batch16", "sw_col_flat_kernel": "col_flat",
    "sw_col_flat16_kernel": "col_flat16", "sw_col_fused_kernel": "col_fused",
    "sw_col_fused16_kernel": "col_fused16",
}


def bench_child(mode: str) -> dict:
    """python -m cudasw4_tpu_torch.bench in a child process under BENCH_ENV
    and BENCH_MODE=``mode``: exactly one stdout line, bench.py's keys and
    metric with a value > 0; one ``# L=`` line per sweep config; every
    config resident; the child's launch counters show the path.  Returns
    the line and the stderr figures."""
    from cudasw4_tpu_torch.bench import SWEEP_LENGTHS, metric_name

    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "cudasw4_tpu_torch.bench"], capture_output=True,
                       text=True, cwd=REPO, timeout=900,
                       env=dict(os.environ, BENCH_MODE=mode, **BENCH_ENV))
    seconds = time.perf_counter() - t0
    check(r.returncode == 0, f"bench {mode}: exit {r.returncode}: {r.stderr[-3000:]}")
    out = r.stdout.splitlines()
    check(len(out) == 1, f"bench {mode}: {len(out)} stdout lines: {out[:5]}")
    line = json.loads(out[0])
    check(list(line) == ["metric", "value", "unit", "vs_baseline"]
          and line["metric"] == metric_name(mode) and line["unit"] == "GCUPS"
          and line["value"] > 0, f"bench {mode}: {out[0]}")
    err = r.stderr.splitlines()
    configs = [m for m in map(BENCH_L_LINE.match, err) if m]
    n_configs = len(SWEEP_LENGTHS) if mode == "sweep" else 1
    check(len(configs) == (n_configs if mode == "sweep" else 0),
          f"bench {mode}: {len(configs)} '# L=' lines")
    resident = [m for m in map(BENCH_RESIDENT_LINE.match, err) if m]
    check(len(resident) == n_configs, f"bench {mode}: {len(resident)} resident configs")
    counts = {k: tuple(v) for k, v in json.loads(
        [x for x in err if x.startswith("# launches: ")][-1][len("# launches: "):]).items()}
    check_path(counts, f"bench {mode}", ("cell", "cell_batch", "col", "col_flat")
               if mode == "sweep" else ("cell", "cell_batch"))
    return {**line, "env": BENCH_ENV,
            "configs": [{"L": int(m[1]), "gcups": float(m[2]), "seconds": float(m[3])}
                        for m in configs],
            "reps": [{"rep": int(m[1]), "L": int(m[2]), "seconds": float(m[3]),
                      "gcups": float(m[4])} for m in map(BENCH_REP_LINE.match, err) if m],
            "resident": [{"num": int(m[1]), "L": int(m[2]), "tile_bytes": int(m[3]),
                          "peak_device_bytes": int(m[4])} for m in resident],
            "launches": {k: v[0] for k, v in counts.items()}, "seconds": seconds}


def check_hits(name, db, queries, results, cfg) -> None:
    """Each query's hits: in (descending score, ascending id) order, and
    each score the vectorised oracle's for its subject."""
    from cudasw4_tpu_torch.constants import encode
    from cudasw4_tpu_torch.ops import oracle

    for qi, (q, res) in enumerate(zip(queries, results)):
        hs = list(zip(res.scores, res.reference_ids))
        check(hs == sorted(hs, key=lambda h: (-h[0], h[1])), f"{name} query {qi}: tie order")
        subs = [db.get_sequence(r) for r in res.reference_ids]
        block = np.full((len(subs), max(len(x) for x in subs)), cfg.pad_code, np.int8)
        for k, x in enumerate(subs):
            block[k, : len(x)] = x
        want = oracle.sw_score_rowvec(encode(q), block, cfg.matrix, cfg.gop, cfg.gex)
        check(res.scores == [int(v) for v in want], f"{name} query {qi}: scores differ from the oracle")


def phase_bench(kernels):
    """The benchmark entry points (``bench_child``): the sweep and the peak
    mode; the sweep's results, which num_top=0 does not show: at each sweep L
    a pseudo database of BENCH_HIT_SEQS copies of one subject, every hit of
    the 20 queries (two single scans, then scan_many, as the sweep runs
    them) its oracle score with ids 0-9 (the tie rule); the
    reference's peak command for one config on the port's CLI (``align
    --top 0 --verbose --uploadFull --pseudodb``, its Total time line); and
    tools.dbbench at DBBENCH_ARGS, every hit against the oracle.  The
    sweep's launches become the kernels line's ``bench_launches``."""
    from cudasw4_tpu_torch import make_scoring_config
    from cudasw4_tpu_torch.bench import SWEEP_LENGTHS, make_queries
    from cudasw4_tpu_torch.cli import align
    from cudasw4_tpu_torch.constants import encode
    from cudasw4_tpu_torch.db.format import pseudo_to_dbdata
    from cudasw4_tpu_torch.db.pseudo import make_pseudo_db
    from cudasw4_tpu_torch.engine import SearchEngine
    from cudasw4_tpu_torch.ops import oracle
    from cudasw4_tpu_torch.tools import dbbench

    t_phase = time.perf_counter()
    runs = {mode: bench_child(mode) for mode in ("sweep", "peak")}
    for name, k in kernels.items():
        k["bench_launches"] = runs["sweep"]["launches"].get(BENCH_COUNTERS.get(name), 0)

    # Every subject of a pseudo database is one sequence: each query's ten
    # hits score the oracle's score of it, on ids 0-9.  As in the sweep,
    # two single scans (the single-query kernels) and one scan_many (the
    # batch kernels, and singles where a query is past the batch cap).
    t0 = time.perf_counter()
    cfg = make_scoring_config("blosum62")
    queries = make_queries()
    pdbs = {L: make_pseudo_db(BENCH_HIT_SEQS, L) for L in SWEEP_LENGTHS}
    block = np.full((len(SWEEP_LENGTHS), max(SWEEP_LENGTHS)), cfg.pad_code, np.int8)
    for k, L in enumerate(SWEEP_LENGTHS):
        block[k, :L] = pdbs[L].chars[:L]
    want = [oracle.sw_score_rowvec(encode(q), block, cfg.matrix, cfg.gop, cfg.gex) for q in queries]
    reset_counts()
    for k, L in enumerate(SWEEP_LENGTHS):
        eng = SearchEngine(num_top=10)
        eng.set_database(pseudo_to_dbdata(pdbs[L]))
        results = [eng.scan(queries[0]), eng.scan(queries[-1]), *eng.scan_many(queries)]
        for qi, res in zip([0, len(queries) - 1, *range(len(queries))], results):
            check(res.scores == [int(want[qi][k])] * 10 and res.reference_ids == list(range(10)),
                  f"pseudo L={L} query {qi}: {res.scores} {res.reference_ids}, oracle {want[qi][k]}")
        del eng
    hit_counts = read_counts()
    check_path(hit_counts, "pseudo hits", ("cell", "cell_batch", "col", "col_flat"))
    t_hits = time.perf_counter() - t0

    t0 = time.perf_counter()
    reset_counts()
    rc, out = run_cli(align, ["--query", QUERY_SET, "--top", "0", "--verbose", "--uploadFull",
                              "--mat", "blosum62", "--pseudodb", *map(str, BENCH_CLI_PSEUDO)])
    cli_counts = read_counts()
    check(rc == 0, "align --pseudodb failed")
    total = [x for x in out.splitlines() if x.startswith("Total time: ")]
    check(len(total) == 1, f"align --pseudodb: {len(total)} Total time lines")
    total_s, total_gcups = (float(v) for v in
                            total[0].replace("Total time: ", "").replace(" GCUPS", "").split(" s, "))
    check_path(cli_counts, "align --pseudodb", ("col", "col_flat"))
    t_cli = time.perf_counter() - t0

    t0 = time.perf_counter()
    reset_counts()
    db_res, db_lines = captured(dbbench.run, *DBBENCH_ARGS, torch.device("cuda"))
    db_counts = read_counts()
    best = [x for x in db_lines if x.startswith("BEST sprot-like total: ")]
    check(len(best) == 1 and db_res["best_gcups"] > 0, f"dbbench: {db_lines[-3:]}")
    check_path(db_counts, "dbbench", ("cell", "cell_batch", "col", "col_flat"))
    check_hits("dbbench", db_res["db"], db_res["queries"], db_res["results"], cfg)
    t_db = time.perf_counter() - t0
    emit({"phase": "bench", **runs,
          "pseudo_hits": {"sequences": BENCH_HIT_SEQS, "lengths": list(SWEEP_LENGTHS),
                          "oracle_equal": True, "seconds": t_hits,
                          "launches": {k: v[0] for k, v in hit_counts.items()}},
          "cli": {"pseudodb": list(BENCH_CLI_PSEUDO), "total_seconds": total_s,
                  "total_gcups": total_gcups, "seconds": t_cli,
                  "launches": {k: v[0] for k, v in cli_counts.items()}},
          "dbbench": {"args": list(DBBENCH_ARGS), "residues": db_res["residues"],
                      "set_database_s": db_res["set_database_s"],
                      "first_pass_s": db_res["first_pass_s"], "passes": db_res["passes"],
                      "best_gcups": db_res["best_gcups"],
                      "peak_device_bytes": db_res["peak_device_bytes"], "hits_equal_oracle": True,
                      "seconds": t_db, "launches": {k: v[0] for k, v in db_counts.items()}},
          "seconds": time.perf_counter() - t_phase})


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
    emit({"phase": "device", "card": card, "sm_clock_max_mhz": clock_mhz,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tuning_auto_applied": packaged_tuning()})
    defaults = tuning_state()
    phase_build()
    phase_kernels(clock_mhz)
    phase_golden()
    kernels, ctx = phase_sprot(clock_mhz)
    phase_state16(ctx, kernels)
    phase_long_query(ctx)
    phase_routing(ctx)
    phase_stream(ctx, kernels)
    phase_mesh(ctx, kernels)
    phase_tools(kernels)
    phase_colstate16(kernels, clock_mhz)
    phase_warmup(ctx)
    phase_tuning(ctx, defaults)
    phase_native(ctx)
    phase_profile(ctx)
    phase_bench(kernels)
    for k in kernels.values():
        check(k["launches"] or k["path"] is None, f"{k['name']} never launched on its path")
    emit({"kernels": list(kernels.values())})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--warmup-child"]:
        sys.exit(warmup_child(*sys.argv[2:]))
    if sys.argv[1:2] == ["--colstate16-child"]:
        sys.exit(colstate16_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--stream-trace-child"]:
        sys.exit(stream_trace_child(*sys.argv[2:]))
    sys.exit(main())
