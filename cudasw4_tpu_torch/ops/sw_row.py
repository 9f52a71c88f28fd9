"""Row-layout scoring: one query against tiles [T, L, NS] (the counterpart of
cudasw4_tpu/ops/sw_pallas.py::score_bucket_pallas and prepare_query).

The kernels are in csrc/sw_tiles.cu (its note gives the design and the
bound on the H100): up to the largest cell instance (L <= 768) the cell
group routine at a code stride of NS (``sw_row_kernel``, at the (G, R)
that ``sw_cell.cell_shape`` picks), past it the col wavefront without a
carry (``sw_row_col_kernel``); ``row_route`` says which.  There is no
length cap, so row buckets longer than the JAX package's single-pass limit
(``is_long``) run on them too.  ``score_bucket_row`` launches them for
CUDA tensors and takes the plain version only for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import UNKNOWN
from . import cuda_lib
from .sw_cell import QCAP, cell_shape
from .sw_torch import score_tiles_torch


def row_route(T: int, L: int, NS: int, nrows: int, budget: int | None = None):
    """How the row kernel runs T row tiles [L, NS] against ``nrows`` query
    rows: ("cell", (G, R), T, 0) up to the largest cell instance, with no
    scratch; past it ("col", None, tiles per group, pool bytes of a group),
    the col wavefront, whose int32 boundary columns [tiles x NS, nrows] x 2
    (``cuda_lib.col_boundary_bytes``; a col-route L always spans more than
    one pass) keep a group within ``budget`` (default
    ``cuda_lib.TEMP_BYTES``): at least one tile a group."""
    shape = cell_shape(L)
    if shape is not None:
        return "cell", shape, T, 0
    per_tile = cuda_lib.col_boundary_bytes(1, nrows, ns=NS)
    budget = cuda_lib.TEMP_BYTES if budget is None else budget
    tc = T if per_tile == 0 else max(1, min(T, budget // per_tile))
    return "col", None, tc, tc * per_tile


def score_bucket_row_plain(tiles, query, matrix_flat, params):
    """Plain PyTorch version of the row kernel: f32 [T, NS]."""
    nq, gop, gex = int(params[0]), int(params[1]), int(params[2])
    A = cuda_lib.alphabet_dim(matrix_flat)
    return score_tiles_torch(tiles, query, matrix_flat.view(A, A), gop, gex, nq)


def score_bucket_row(tiles, query, matrix_flat, params, temp_bytes: int | None = None):
    """Scores f32 [T, NS] of one query against a row bucket.

    ``tiles``: int8 [T, L, NS]; ``query``: int32 [>= nq], padded with the
    pad code; ``matrix_flat``: int32 [A*A]; ``params``: host ints
    (nq, gop, gex, _).  Codes must lie in [0, A).  Past the cell route the
    tiles run in groups whose boundary columns fit ``temp_bytes``
    (``row_route``), one launch a group.
    """
    if tiles.dim() != 3:
        raise ValueError(f"row tiles must be [T, L, NS], got {tuple(tiles.shape)}")
    if tiles.device.type == "cpu":
        score_bucket_row.plain_calls += 1
        return score_bucket_row_plain(tiles, query, matrix_flat, params)
    nq, gop, gex = int(params[0]), int(params[1]), int(params[2])
    T, L, NS = tiles.shape
    route, _, tc, _ = row_route(T, L, NS, nq, temp_bytes)
    parts = [cuda_lib.launch_row(score_bucket_row, tiles[t0 : t0 + tc], query, matrix_flat,
                                 nq, gop, gex, pool=route == "col")
             for t0 in range(0, max(T, 1), max(tc, 1))]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


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
