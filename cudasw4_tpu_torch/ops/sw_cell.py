"""Cell-layout scoring against tiles of 32 x 128 subjects: one query (the
counterpart of cudasw4_tpu/ops/sw_pallas_cell.py::score_bucket_pallas_cell,
exact int32 or int16 state), the same with the tiles staged by hand
(score_bucket_pallas_cell_manual), or a batch of queries in one launch
(score_bucket_pallas_cell_batch, exact int32 or int16 state).

The kernels are ``sw_cell_kernel``, ``sw_cell16_kernel``,
``sw_cell_batch_kernel``, ``sw_manual_kernel`` and ``sw_manual16_kernel``
in csrc/sw_cell.cuh (csrc/sw_tiles.cu's note gives the design and the
bound on the H100).  All are single-pass group wavefronts
(``cell_group``), one instance per (G, R) of CELL_SHAPES, picked for the
tiles' L by ``cell_shape``; the s16x2 kernel ``sw_cell16_kernel`` serves
the batch too, a slot on the grid's y axis, and the manual kernels feed
the same routine from a ring in shared memory.  B1 and B4 launch the
s16x2 kernel in both state modes: its scores are exact (each block
proves that its lanes cannot wrap, or runs in int32 lanes), and it takes
0.56-0.73 of the int32 kernels' time at the Swiss-Prot buckets
(PERF.md).  Exact launches count their slots by lanes (``s16x2_slots``,
``int32_slots``, ``cuda_lib.count_slots``).  Tiles longer than the
largest instance take the col wavefront's passes (``sw_col_kernel``,
``sw_col16_kernel``, ``sw_col_flat_kernel``, ``sw_col_flat16_kernel``) on
the same layout, counted on the wrapper that was called.  The wrappers
launch them for CUDA tensors and take their plain versions only for CPU
tensors.  Each counts its launches and plain calls per mode (``launches`` and
``plain_calls`` for exact state, ``launches16`` and ``plain_calls16`` for
int16 state).
"""

from __future__ import annotations

import itertools

import torch

from . import cuda_lib
from .sw_torch import score_tiles_torch

#: Subjects per tile: G x NSL = 32 x 128, stored as [T, L, G, NSL].
G = 32
NSL = 128

#: int16-state saturation ceiling (``exact=False``): a subject whose
#: true score is below SAT scores exactly, one whose score reaches it
#: returns >= SAT, which flags its tile for the engine's exact re-score.
#: Read at every call, so tests may lower it.
SAT = 32000

#: Query chars per kernel call: the engine pads every query to this; a
#: longer query grows its block in steps of QCAP (the kernels have no cap).
QCAP = 8192

#: Query capacity of a batch slot: the engine's batch width on a database
#: without col buckets (with them, the col kernel's NQC caps it).
QCAP_BATCH = 8192

#: Query-row granule: the JAX kernels' unroll, which the cell batch
#: contract keeps (L a multiple of it), and the padding granule of the col
#: kernels' row counts.
DEFAULT_UNROLL = 8

#: The (G, R) instances of the cell group kernels (csrc/sw_cell.cuh,
#: CELL_SHAPES): a group of G lanes scores one subject (two in the int16
#: kernel's s16x2 lanes), each lane holding R consecutive subject columns
#: in registers.  G = 8 up to L = 256, G = 16 up to 576, G = 32 above
#: (chosen on the H100, PERF.md): every multiple of 16 up to CELL_MAX_L =
#: 768 is G x R of one of them, or 16 short of one past 576.
CELL_SHAPES = (
    *((8, r) for r in range(2, 33, 2)),
    *((16, r) for r in range(17, 37)),
    *((32, r) for r in range(19, 25)),
)


def cell_shape(L: int) -> tuple[int, int] | None:
    """The (G, R) instance that scores cell tiles of L positions in one
    pass: the least G x R >= L, then the least G.  None past the largest
    instance (768 columns): such tiles take the col wavefront's passes."""
    fits = [(g * r, g, r) for g, r in CELL_SHAPES if g * r >= L]
    return min(fits)[1:] if fits else None


def sat_state(exact: bool) -> int | None:
    """The int16 ceiling of a call: None for exact state, else SAT (read
    now, so a lowered SAT takes effect)."""
    return None if exact else cuda_lib.check_sat(SAT)


def sat_match(got, want, sat: int | None = None):
    """Bool tensor: where each score of an int16-state run ``got`` meets
    the SAT rule against the exact or int16 scores ``want``: ``got >= SAT``
    where ``want >= SAT``, else ``got == want``.  Every int16 comparison of
    the port uses it."""
    sat = SAT if sat is None else sat
    return torch.where(want >= sat, got >= sat, got == want)


def _cell_tiles(tiles) -> None:
    if tiles.dim() != 4 or tuple(tiles.shape[2:]) != (G, NSL):
        raise ValueError(f"cell tiles must be [T, L, {G}, {NSL}], got {tuple(tiles.shape)}")


def score_bucket_cell_plain(tiles, query, matrix_flat, params, exact: bool = True):
    """Plain PyTorch version of the cell kernel: f32 [T, 4096]."""
    nq, gop, gex = int(params[0]), int(params[1]), int(params[2])
    T, L, g, nsl = tiles.shape
    A = cuda_lib.alphabet_dim(matrix_flat)
    return score_tiles_torch(
        tiles.reshape(T, L, g * nsl), query, matrix_flat.view(A, A), gop, gex, nq,
        sat=sat_state(exact),
    )


def score_bucket_cell(tiles, query, matrix_flat, params, exact: bool = True):
    """Scores f32 [T, 4096] of one query against a cell bucket.

    ``tiles``: int8 [T, L, 32, 128]; ``query``: int32 [>= nq], padded with
    the pad code; ``matrix_flat``: int32 [A*A]; ``params``: host ints
    (nq, gop, gex, _).  Codes must lie in [0, A).  ``exact=False``: the
    int16 contract, saturating at SAT (see ``sat_match``); the card's
    s16x2 kernel returns the exact scores, which meet it.
    """
    _cell_tiles(tiles)
    if tiles.device.type == "cpu":
        cuda_lib.count(score_bucket_cell, exact, plain=True)
        return score_bucket_cell_plain(tiles, query, matrix_flat, params, exact)
    sat = sat_state(exact) or 0
    shape = cell_shape(tiles.shape[1])
    if shape is None:
        return col_route(score_bucket_cell, tiles, query, matrix_flat, params, sat)
    nq, gop, gex = int(params[0]), int(params[1]), int(params[2])
    cuda_lib.check_query_rows(query, nq, tiles.device)
    kernel = "sw_cell16_kernel" if exact else "sw_cell_kernel"
    return cuda_lib.launch_cell(score_bucket_cell, kernel, tiles, query[:nq].view(1, nq),
                                matrix_flat, gop, gex, nq, shape, sat)[0]


score_bucket_cell.launches = score_bucket_cell.launches16 = 0
score_bucket_cell.plain_calls = score_bucket_cell.plain_calls16 = 0
score_bucket_cell.s16x2_slots = score_bucket_cell.int32_slots = 0


def col_route(wrapper, tiles, query, matrix_flat, params, sat: int):
    """One query against cell tiles longer than the largest cell instance:
    the col wavefront's passes (``sw_col_kernel``, ``sw_col16_kernel`` for
    ``sat`` > 0) on the same layout, counted on ``wrapper``; f32 [T, 4096].
    Arguments as ``score_bucket_cell``'s."""
    nq, gop, gex = int(params[0]), int(params[1]), int(params[2])
    cuda_lib.check_query_rows(query, nq, tiles.device)
    return cuda_lib.launch_col(wrapper, "sw_col_kernel", tiles, query[:nq].view(1, nq),
                               matrix_flat, gop, gex, sat=sat)[0][0]


def score_bucket_cell_manual(tiles, query, matrix_flat, params, exact: bool = True):
    """``score_bucket_cell`` with the tiles staged by hand (the counterpart
    of score_bucket_pallas_cell_manual): a persistent grid whose blocks
    copy units of 16 or 32 subjects' codes, whole, into a 2-deep
    shared-memory ring with cp.async, starting the next unit's copy before
    their groups sweep the current one with B1's routine (s16x2 lanes
    under ``exact=False``, exact scores as B1 int16's).  Past the largest
    cell instance it takes B1's route, the col kernel, counted here.

    Same contract and results as ``score_bucket_cell``.  The TPU kernel's
    ``priority`` (its DMA queue) has no Hopper counterpart and is not
    taken.  Its plain version is ``score_bucket_cell_plain``.
    """
    _cell_tiles(tiles)
    if tiles.device.type == "cpu":
        cuda_lib.count(score_bucket_cell_manual, exact, plain=True)
        return score_bucket_cell_plain(tiles, query, matrix_flat, params, exact)
    sat = sat_state(exact) or 0
    shape = cell_shape(tiles.shape[1])
    if shape is None:
        return col_route(score_bucket_cell_manual, tiles, query, matrix_flat, params, sat)
    return cuda_lib.launch_tool(score_bucket_cell_manual, "sw_manual_kernel", tiles, query,
                                matrix_flat, params, shape, sat, 0)


score_bucket_cell_manual.launches = score_bucket_cell_manual.launches16 = 0
score_bucket_cell_manual.plain_calls = score_bucket_cell_manual.plain_calls16 = 0


def score_bucket_cell_batch_plain(tiles, queries, matrix_flat, params, exact: bool = True):
    """Plain PyTorch version of the cell batch kernel: each slot scored
    alone over its nq rows, f32 [QB, T, 4096]."""
    gop, gex = int(params[1]), int(params[2])
    T, L, g, nsl = tiles.shape
    A = cuda_lib.alphabet_dim(matrix_flat)
    x, mat = tiles.reshape(T, L, g * nsl), matrix_flat.view(A, A)
    sat = sat_state(exact)
    return torch.stack([
        score_tiles_torch(x, queries[qb], mat, gop, gex, int(params[4 + qb]), sat=sat)
        for qb in range(queries.shape[0])
    ])


def score_bucket_cell_batch(tiles, queries, matrix_flat, params, exact: bool = True):
    """Scores f32 [QB, T, 4096] of QB queries against a cell bucket in one
    launch.

    ``tiles``: int8 [T, L, 32, 128], L a multiple of DEFAULT_UNROLL;
    ``queries``: int32 [QB, W] padded with the pad code; ``params``: host
    ints [4 + QB (+ QB)] = _, gop, gex, _, nq_0.. (further entries, the
    batch layout's padded row counts, are ignored).  A slot with nq = 0
    scores 0.  Codes must lie in [0, A).  ``exact=False``: the int16
    contract, saturating at SAT (``sat_match``); the card's s16x2 kernel
    returns the exact scores, and past the largest instance the col flat
    kernel runs in int16 state.
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
        cuda_lib.count(score_bucket_cell_batch, exact, plain=True)
        return score_bucket_cell_batch_plain(tiles, queries, matrix_flat, params, exact)
    gop, gex = int(params[1]), int(params[2])
    sat = sat_state(exact) or 0
    shape = cell_shape(tiles.shape[1])
    if shape is None:  # each slot's boundary columns in its own pool range
        offs = list(itertools.accumulate(nqs, initial=0))[:-1]
        slots = (nqs, offs, max(W, sum(nqs)))
        return cuda_lib.launch_col(score_bucket_cell_batch, "sw_col_flat_kernel", tiles,
                                   queries, matrix_flat, gop, gex, slots=slots, sat=sat)[0]
    kernel = "sw_cell16_kernel" if exact else "sw_cell_batch_kernel"
    return cuda_lib.launch_cell(score_bucket_cell_batch, kernel, tiles, queries, matrix_flat,
                                gop, gex, nqs, shape, sat)


score_bucket_cell_batch.launches = score_bucket_cell_batch.launches16 = 0
score_bucket_cell_batch.plain_calls = score_bucket_cell_batch.plain_calls16 = 0
score_bucket_cell_batch.s16x2_slots = score_bucket_cell_batch.int32_slots = 0
