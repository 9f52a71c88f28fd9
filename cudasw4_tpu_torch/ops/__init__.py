"""Scoring kernels and the per-bucket dispatch (the counterpart of
cudasw4_tpu/ops/__init__.py: score_bucket, bucket_kind, col_flat_plan,
batch_col_scores).

One CUDA kernel per TPU kernel on the resident paths: the single-query
kernels (cell, row, col; cell and col also with int16 state) and the batch
kernels (cell batch, col flat, col fused), each with its plain PyTorch
version in the same module.  The
dispatch is by bucket kind on every device; each wrapper takes its plain
version only for CPU tensors, so the CPU walks the same branches as the
card.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_lib, sw_cell, sw_col, sw_row


def score_bucket(tiles, qpad, matrix_flat, params, kind: str, exact: bool = True,
                 temp_bytes: int | None = None, lengths=None):
    """Score one bucket's tiles against one query; returns f32 [T, NS].

    ``qpad``: int32 [>= nq] query block padded with the pad code;
    ``params``: host ints (nq, gop, gex, nq_pad), nq_pad the query rows
    rounded up to the unroll granule.  For "col" the caller guarantees
    nq_pad <= sw_col.NQC; longer queries go through
    sw_col.score_bucket_col_any_query.  ``exact=False``: int16 state on
    cell and col buckets; the row kernel is int32 only, as the JAX
    package's is, so its scores are exact in both modes.  ``temp_bytes``:
    the cap of a row tile group's boundary columns (``sw_row.row_route``).
    ``lengths``: the tiles' subject lengths (``sw_col.ColLengths``), which
    the col kernel takes, or None.
    """
    if kind == "cell":
        return sw_cell.score_bucket_cell(tiles, qpad, matrix_flat, params, exact=exact)
    if kind == "row":
        return sw_row.score_bucket_row(tiles, qpad, matrix_flat, params, temp_bytes)
    if kind == "col":
        nq_pad = int(params[3])
        pc = (nq_pad, int(params[1]), int(params[2]), nq_pad)
        q = qpad[: min(sw_col.NQC, qpad.shape[0])]
        return sw_col.score_bucket_col(tiles, q, matrix_flat, pc, exact=exact, lengths=lengths)
    raise ValueError(f"unknown bucket kind {kind!r}")


def col_flat_plan(pads, limit=None, rtot=None, smax=8):
    """Bin-pack batch slots into flat-pool col passes, first-fit
    decreasing.

    ``pads``: per-slot unroll-padded query row counts; ``limit``: only the
    first ``limit`` slots are real.  Returns a tuple of passes, each a tuple
    of (slot, pool row offset) pairs whose reservations (pads rounded up to
    FLAT_QUANT) sum to at most ``rtot`` (default NQC), with at most
    ``smax`` slots.  Raises ValueError for a slot longer than the pool.
    """
    if rtot is None:
        rtot = sw_col.NQC
    n = len(pads) if limit is None else min(int(limit), len(pads))
    order = sorted(range(n), key=lambda i: -int(pads[i]))
    passes: list[list] = []  # [rows_reserved, [(slot, off), ...]]
    for i in order:
        p = int(pads[i])
        if p > rtot:
            raise ValueError(
                f"slot {i} needs {p} state rows > pool {rtot}; the caller must "
                "route queries longer than the pool to the chunked single-query path"
            )
        r = -(-p // sw_col.FLAT_QUANT) * sw_col.FLAT_QUANT
        for entry in passes:
            if entry[0] + r <= rtot and len(entry[1]) < smax:
                entry[1].append((i, entry[0]))
                entry[0] += r
                break
        else:
            passes.append([r, [(i, 0)]])
    return tuple(tuple(e[1]) for e in passes)


def batch_col_scores(tiles, queries, matrix_flat, params, QB: int, plan, rtot=None,
                     temp_bytes=None, lengths=None):
    """Score a col bucket for a QB-query batch, one flat-pool launch per
    plan entry.

    ``queries``: int32 [QB, W] on the tiles' device; ``params``: host ints,
    the batch layout [4 + 2*QB] = _, gop, gex, _, nq_0.., pad_0.. (pads
    are the unroll-padded rows the slots run); ``plan``: from
    col_flat_plan.  Yields (scores [S_pass, T, 4096], slots): row i of the
    scores belongs to batch slot slots[i].  A pass of at least
    sw_col.COL_FUSE_MIN_S slots (when that is > 0) runs on the fused
    kernel, the others on the flat kernel.  Each pass launches once per
    group of as many tiles as keep the pool's boundary columns
    (``cuda_lib.col_boundary_bytes``, 100.7 MB a tile at 3072 rows) within
    ``temp_bytes`` (default ``cuda_lib.TEMP_BYTES``), so that no chunk or
    bucket size makes them outgrow the card.  ``lengths``: the tiles'
    subject lengths (``sw_col.ColLengths``), each group's launch taking its
    tiles' share, or None.
    """
    T = tiles.shape[0]
    budget = cuda_lib.TEMP_BYTES if temp_bytes is None else temp_bytes
    tc = max(1, budget // cuda_lib.col_boundary_bytes(1, sw_col.NQC if rtot is None else rtot))
    for slots_offs in plan:
        idx = [s for s, _ in slots_offs]
        offs = tuple(o for _, o in slots_offs)
        qs = queries.index_select(0, cuda_lib.to_device(np.asarray(idx, np.int64), queries.device))
        pcol = [int(v) for v in params[:4]] + [int(params[4 + QB + s]) for s in idx]
        fmin = sw_col.COL_FUSE_MIN_S
        parts = []
        for t0 in range(0, max(T, 1), tc):
            sub = tiles[t0 : t0 + tc]
            lens = None if lengths is None else lengths[t0 : t0 + tc]
            if fmin > 0 and len(offs) >= fmin:
                parts.append(sw_col.score_bucket_col_flat_fused(sub, qs, matrix_flat, pcol,
                                                                rtot=rtot, lengths=lens))
            else:
                parts.append(sw_col.score_bucket_col_flat(sub, qs, matrix_flat, pcol, offs,
                                                          rtot=rtot, lengths=lens))
        yield parts[0] if len(parts) == 1 else torch.cat(parts, dim=1), tuple(idx)


def bucket_kind(bucket) -> str:
    """Dispatch kind of a packed bucket: its layout.

    The JAX package sends long row buckets (``is_long``) and col buckets
    under an over-long query to its portable scorer; here the row kernel
    has no length cap and the engine chunks long queries on col buckets,
    so every bucket runs on its own layout's kernel.
    """
    return bucket.kernel
