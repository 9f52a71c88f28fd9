"""Scoring kernels and the per-bucket dispatch (the counterpart of
cudasw4_tpu/ops/__init__.py::score_bucket and bucket_kind).

One CUDA kernel per TPU kernel on the resident single-query path (cell,
row, col), each with its plain PyTorch version in the same module.  The
dispatch is by bucket kind on every device; each wrapper takes its plain
version only for CPU tensors, so the CPU walks the same branches as the
card.
"""

from __future__ import annotations

from . import sw_cell, sw_col, sw_row


def score_bucket(tiles, qpad, matrix_flat, params, kind: str):
    """Score one bucket's tiles against one query; returns f32 [T, NS].

    ``qpad``: int32 [QCAP] query block padded with the pad code;
    ``params``: host ints (nq, gop, gex, nq_pad), nq_pad the query rows
    rounded up to the unroll granule.  For "col" the caller guarantees
    nq_pad <= sw_col.NQC; longer queries go through
    sw_col.score_bucket_col_any_query.
    """
    if kind == "cell":
        return sw_cell.score_bucket_cell(tiles, qpad, matrix_flat, params)
    if kind == "row":
        return sw_row.score_bucket_row(tiles, qpad, matrix_flat, params)
    if kind == "col":
        nq_pad = int(params[3])
        pc = (nq_pad, int(params[1]), int(params[2]), nq_pad)
        q = qpad[: min(sw_col.NQC, qpad.shape[0])]
        return sw_col.score_bucket_col(tiles, q, matrix_flat, pc)
    raise ValueError(f"unknown bucket kind {kind!r}")


def bucket_kind(bucket) -> str:
    """Dispatch kind of a packed bucket: its layout.

    The JAX package sends long row buckets (``is_long``) and col buckets
    under an over-long query to its portable scorer; here the row kernel
    has no length cap and the engine chunks long queries on col buckets,
    so every bucket runs on its own layout's kernel.
    """
    return bucket.kernel
