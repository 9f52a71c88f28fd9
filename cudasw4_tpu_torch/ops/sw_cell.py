"""Cell-layout scoring against tiles of 32 x 128 subjects, exact int32
state: one query (the counterpart of
cudasw4_tpu/ops/sw_pallas_cell.py::score_bucket_pallas_cell) or a batch of
queries in one launch (score_bucket_pallas_cell_batch).

The kernels are ``sw_cell_kernel`` and ``sw_cell_batch_kernel`` in
csrc/sw_tiles.cu (its note gives the design and the bound on the H100).
``score_bucket_cell`` and ``score_bucket_cell_batch`` launch them for CUDA
tensors and take their plain versions only for CPU tensors.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .sw_torch import score_tiles_torch

#: Subjects per tile: G x NSL = 32 x 128, stored as [T, L, G, NSL].
G = 32
NSL = 128

#: int16-state saturation ceiling of the JAX package's default mode; the
#: port runs exact int32 state only (int16 state is a later slice).
SAT = 32000

#: Query chars per kernel call: the engine pads every query to this.
QCAP = 8192

#: Query capacity of a batch slot: the engine's batch width on a database
#: without col buckets (with them, the col kernel's NQC caps it).
QCAP_BATCH = 8192

#: Query-row granule: the register block of the kernel and the padding
#: granule of the col kernel's row counts.
DEFAULT_UNROLL = 8


def _cell_tiles(tiles) -> None:
    if tiles.dim() != 4 or tuple(tiles.shape[2:]) != (G, NSL):
        raise ValueError(f"cell tiles must be [T, L, {G}, {NSL}], got {tuple(tiles.shape)}")


def score_bucket_cell_plain(tiles, query, matrix_flat, params):
    """Plain PyTorch version of the cell kernel: f32 [T, 4096]."""
    nq, gop, gex = int(params[0]), int(params[1]), int(params[2])
    T, L, g, nsl = tiles.shape
    A = cuda_lib.alphabet_dim(matrix_flat)
    return score_tiles_torch(
        tiles.reshape(T, L, g * nsl), query, matrix_flat.view(A, A), gop, gex, nq
    )


def score_bucket_cell(tiles, query, matrix_flat, params):
    """Scores f32 [T, 4096] of one query against a cell bucket.

    ``tiles``: int8 [T, L, 32, 128]; ``query``: int32 [>= nq], padded with
    the pad code; ``matrix_flat``: int32 [A*A]; ``params``: host ints
    (nq, gop, gex, _).  Codes must lie in [0, A).
    """
    _cell_tiles(tiles)
    if tiles.device.type == "cpu":
        score_bucket_cell.plain_calls += 1
        return score_bucket_cell_plain(tiles, query, matrix_flat, params)
    return cuda_lib.launch(score_bucket_cell, "sw_cell_kernel", tiles, query, matrix_flat, params)[0]


score_bucket_cell.launches = 0
score_bucket_cell.plain_calls = 0


def score_bucket_cell_batch_plain(tiles, queries, matrix_flat, params):
    """Plain PyTorch version of the cell batch kernel: each slot scored
    alone over its nq rows, f32 [QB, T, 4096]."""
    gop, gex = int(params[1]), int(params[2])
    T, L, g, nsl = tiles.shape
    A = cuda_lib.alphabet_dim(matrix_flat)
    x, mat = tiles.reshape(T, L, g * nsl), matrix_flat.view(A, A)
    return torch.stack([
        score_tiles_torch(x, queries[qb], mat, gop, gex, int(params[4 + qb]))
        for qb in range(queries.shape[0])
    ])


def score_bucket_cell_batch(tiles, queries, matrix_flat, params):
    """Scores f32 [QB, T, 4096] of QB queries against a cell bucket in one
    launch.

    ``tiles``: int8 [T, L, 32, 128], L a multiple of DEFAULT_UNROLL;
    ``queries``: int32 [QB, W] padded with the pad code; ``params``: host
    ints [4 + QB (+ QB)] = _, gop, gex, _, nq_0.. (further entries, the
    batch layout's padded row counts, are ignored).  A slot with nq = 0
    scores 0.  Codes must lie in [0, A).
    """
    _cell_tiles(tiles)
    if tiles.shape[1] % DEFAULT_UNROLL:
        raise ValueError(f"cell tiles' L={tiles.shape[1]} is not a multiple of {DEFAULT_UNROLL}")
    if queries.dim() != 2 or queries.shape[0] == 0:
        raise ValueError(f"queries must be [QB >= 1, W], got {tuple(queries.shape)}")
    QB, W = queries.shape
    if len(params) < 4 + QB:
        raise ValueError(f"params hold {len(params)} entries, expected 4 + {QB}")
    nqs = [int(params[4 + qb]) for qb in range(QB)]
    for qb, nq in enumerate(nqs):
        if not 0 <= nq <= W:
            raise ValueError(f"slot {qb}: {nq} query rows outside the query block of {W}")
    if tiles.device.type == "cpu":
        score_bucket_cell_batch.plain_calls += 1
        return score_bucket_cell_batch_plain(tiles, queries, matrix_flat, params)
    return cuda_lib.launch_batch(
        score_bucket_cell_batch, "sw_cell_batch_kernel", tiles, queries, nqs,
        matrix_flat, int(params[1]), int(params[2]), cuda_lib.scratch_planes(tiles, QB),
    )


score_bucket_cell_batch.launches = 0
score_bucket_cell_batch.plain_calls = 0
