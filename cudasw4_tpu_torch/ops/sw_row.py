"""Row-layout scoring: one query against tiles [T, L, NS] (the counterpart of
cudasw4_tpu/ops/sw_pallas.py::score_bucket_pallas and prepare_query).

The kernel is ``sw_row_kernel`` in csrc/sw_tiles.cu (its note gives the
design and the bound on the H100).  It has no length cap, so row buckets
longer than the JAX package's single-pass limit (``is_long``) run on it
too.  ``score_bucket_row`` launches it for CUDA tensors and takes the plain
version only for CPU tensors.
"""

from __future__ import annotations

import numpy as np

from ..constants import UNKNOWN
from . import cuda_lib
from .sw_cell import QCAP
from .sw_torch import score_tiles_torch


def score_bucket_row_plain(tiles, query, matrix_flat, params):
    """Plain PyTorch version of the row kernel: f32 [T, NS]."""
    nq, gop, gex = int(params[0]), int(params[1]), int(params[2])
    A = cuda_lib.alphabet_dim(matrix_flat)
    return score_tiles_torch(tiles, query, matrix_flat.view(A, A), gop, gex, nq)


def score_bucket_row(tiles, query, matrix_flat, params):
    """Scores f32 [T, NS] of one query against a row bucket.

    ``tiles``: int8 [T, L, NS]; ``query``: int32 [>= nq], padded with the
    pad code; ``matrix_flat``: int32 [A*A]; ``params``: host ints
    (nq, gop, gex, _).  Codes must lie in [0, A).
    """
    if tiles.dim() != 3:
        raise ValueError(f"row tiles must be [T, L, NS], got {tuple(tiles.shape)}")
    if tiles.device.type == "cpu":
        score_bucket_row.plain_calls += 1
        return score_bucket_row_plain(tiles, query, matrix_flat, params)
    return cuda_lib.launch(score_bucket_row, "sw_row_kernel", tiles, query, matrix_flat, params)


score_bucket_row.launches = 0
score_bucket_row.plain_calls = 0


def prepare_query(query_codes, qcap: int = QCAP, pad: int | None = None):
    """Pad an encoded query to [qcap] int32 (pad code, UNKNOWN by default);
    returns (padded numpy array, nq)."""
    q = np.asarray(query_codes, dtype=np.int32)
    nq = len(q)
    if nq > qcap:
        raise ValueError(f"query of length {nq} exceeds kernel capacity {qcap}")
    out = np.full(qcap, UNKNOWN if pad is None else pad, dtype=np.int32)
    out[:nq] = q
    return out, nq
