"""Cell-layout scoring: one query against tiles of 32 x 128 subjects (the
counterpart of cudasw4_tpu/ops/sw_pallas_cell.py::score_bucket_pallas_cell,
exact int32 state).

The kernel is ``sw_cell_kernel`` in csrc/sw_tiles.cu (its note gives the
design and the bound on the H100).  ``score_bucket_cell`` launches it for
CUDA tensors and takes the plain version only for CPU tensors.
"""

from __future__ import annotations

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

#: Query-row granule: the register block of the kernel and the padding
#: granule of the col kernel's row counts.
DEFAULT_UNROLL = 8


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
    if tiles.dim() != 4 or tuple(tiles.shape[2:]) != (G, NSL):
        raise ValueError(f"cell tiles must be [T, L, {G}, {NSL}], got {tuple(tiles.shape)}")
    if tiles.device.type == "cpu":
        score_bucket_cell.plain_calls += 1
        return score_bucket_cell_plain(tiles, query, matrix_flat, params)
    return cuda_lib.launch(score_bucket_cell, "sw_cell_kernel", tiles, query, matrix_flat, params)[0]


score_bucket_cell.launches = 0
score_bucket_cell.plain_calls = 0
