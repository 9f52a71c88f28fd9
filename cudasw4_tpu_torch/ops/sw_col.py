"""Column-layout scoring for long subjects, with the H/F carry between
query chunks (the counterpart of cudasw4_tpu/ops/sw_pallas_col.py:
score_bucket_pallas_col, pad_query_chunk, score_bucket_col_any_query), and
the flat-pool batch of query slots (score_bucket_pallas_col_flat and
score_bucket_pallas_col_flat_fused), each in exact int32 or int16 state.

The kernels are ``sw_col_kernel``, ``sw_col_flat_kernel`` and
``sw_col_fused_kernel`` (``sw_col16_kernel``, ``sw_col_flat16_kernel`` and
``sw_col_fused16_kernel`` for int16 state) in csrc/sw_col.cu
(csrc/sw_tiles.cu's note gives the design and the bound on the H100).  ``score_bucket_col``
keeps the TPU kernel's contract: one query chunk of ``nq_pad`` rows (at
most NQC) against cell-layout tiles whose L is a multiple of LC,
optionally starting from the previous chunk's bottom-row H/F
(``state_in``, int32) and returning its own (``emit_state``, int32 in
both modes); ``exact=False`` runs int16 state saturating at
``sw_cell.SAT``.  Queries longer than NQC run chunk by chunk through
``score_bucket_col_any_query``; per-chunk scores combine by max.
``score_bucket_col_flat`` and ``score_bucket_col_flat_fused`` keep the
flat-pool contracts: S slots of nqp rows each, whose rows fit a pool of
``rtot`` rows; ``exact=False`` runs them in int16 state too.

Every wrapper takes the tiles' subject lengths (``lengths``, a
``ColLengths``): each warp then runs only its own subject's
ceil(len / P) passes of P = ``col_pass`` columns, none for a padding
lane, with the same scores.  A launch counts its warp-passes on the
wrapper, ``col_warp_passes``, beside ``col_bucket_passes``, those that
every warp running the bucket's L would have taken (S x T x 4096 x
ceil(L / P) for S slots); the plain versions sweep every column and count
nothing.
"""

from __future__ import annotations

import itertools
import os

import numpy as np
import torch

from . import cuda_lib, sw_cell
from .sw_cell import DEFAULT_UNROLL, G, NSL
from .sw_row import prepare_query
from .sw_torch import sweep_tiles_torch

#: Subject positions per column chunk: every col bucket's L is a multiple.
LC = 128

#: Query rows per col call; longer queries chunk with the H/F carry.
NQC = 3072

#: Offset quantum of the flat pool: col_flat_plan rounds each slot's
#: reservation up to a multiple of it.
FLAT_QUANT = 128

#: Flat-pool passes with at least this many slots run on the fused kernel;
#: 0, the default, never does (the JAX package's switch, under the port's
#: prefix).
COL_FUSE_MIN_S = int(os.environ.get("CUDASW4_TPU_TORCH_COL_FUSE_MIN_S", 0))

#: Subject columns per col pass where no kernel library runs (the CPU,
#: "meta" tensors): the value of csrc/sw_common.cuh kColPass.
COL_PASS = 512


def col_pass(device) -> int:
    """Subject columns per col pass of the kernels on ``device``: the
    library's kColPass (``sw_col_pass_columns``) on a CUDA device, else
    COL_PASS."""
    if torch.device(device).type == "cuda":
        return cuda_lib.lib().sw_col_pass_columns()
    return COL_PASS


class ColLengths:
    """The subject lengths of col tiles as the col kernels take them.

    ``dev``: int32 [T, 4096] on the tiles' device; ``passes``: host int64
    [T], each tile's warp-passes, the sum of its subjects'
    ceil(len / col_pass(device)), so that a launch counts its passes without
    reading the device.  A slice (``lengths[a:b]``) or ``select`` describes
    the same tiles as ``tiles[a:b]`` or ``tiles.index_select``."""

    def __init__(self, dev: torch.Tensor, passes: np.ndarray):
        self.dev, self.passes = dev, passes

    @classmethod
    def place(cls, lengths, device) -> "ColLengths":
        """``lengths`` (host ints [T, 4096], ``PackedBucket.lengths``) on
        ``device``, on the current stream."""
        host = np.ascontiguousarray(lengths, dtype=np.int32)
        passes = (-(-host.astype(np.int64) // col_pass(device))).sum(axis=1)
        return cls(torch.from_numpy(host).to(device), passes)

    def __getitem__(self, tiles: slice) -> "ColLengths":
        return ColLengths(self.dev[tiles], self.passes[tiles])

    def select(self, idx, idx_dev: torch.Tensor) -> "ColLengths":
        """The lengths of tiles ``idx`` (host ints), ``idx_dev`` the same
        indices on the device."""
        return ColLengths(self.dev.index_select(0, idx_dev), self.passes[np.asarray(idx)])


def _count_passes(wrapper, lengths: ColLengths | None, tiles, S: int) -> None:
    """Count a launch of S slots on ``tiles`` (T tiles of L columns) on the
    wrapper: ``col_bucket_passes`` as if every warp ran all L,
    ``col_warp_passes`` as the warps run (the same without ``lengths``)."""
    T, L = tiles.shape[0], tiles.shape[1]
    full = S * T * G * NSL * -(-L // col_pass(tiles.device))
    wrapper.col_bucket_passes += full
    wrapper.col_warp_passes += full if lengths is None else S * int(lengths.passes.sum())


def _lengths_dev(lengths: ColLengths | None):
    return None if lengths is None else lengths.dev


def _params(params):
    return int(params[0]), int(params[1]), int(params[2])


def score_bucket_col_plain(tiles, query, matrix_flat, params, state_in=None,
                           emit_state: bool = False, exact: bool = True):
    """Plain PyTorch version of the col kernel (same contract)."""
    nqp, gop, gex = _params(params)
    T, L, g, nsl = tiles.shape
    A = cuda_lib.alphabet_dim(matrix_flat)
    h0 = f0 = None
    if state_in is not None:
        h0 = state_in[0].reshape(T, L, g * nsl)
        f0 = state_in[1].reshape(T, L, g * nsl)
    rows = query[:nqp]
    if isinstance(rows, torch.Tensor):
        rows = rows.tolist()
    best, H, F = sweep_tiles_torch(
        tiles.reshape(T, L, g * nsl), rows, matrix_flat.view(A, A), gop, gex, h0, f0,
        sat=sw_cell.sat_state(exact),
    )
    scores = best.float()
    if emit_state:
        return scores, (H.reshape(T, L, g, nsl), F.reshape(T, L, g, nsl))
    return scores


def score_bucket_col(tiles, query, matrix_flat, params, state_in=None,
                     take_init: bool = False, emit_state: bool = False,
                     exact: bool = True, lengths: ColLengths | None = None):
    """Scores f32 [T, 4096] = per-subject max over this query chunk's rows.

    ``tiles``: int8 [T, L, 32, 128] with L % LC == 0; ``query``: int32
    [NQC] chunk padded with the pad code; ``params``: host ints
    (nq_pad, gop, gex, _), nq_pad the rows to run; ``state_in``: (hrow,
    frow) int32 [T, L, 32, 128] from the previous chunk, given exactly when
    ``take_init``.  With ``emit_state`` also returns (hrow, frow), int32:
    the last row's H/F, the next chunk's ``state_in``.  ``exact=False``:
    int16 state saturating at ``sw_cell.SAT`` (``sw_cell.sat_match``).

    ``lengths``: the tiles' subject lengths, or None.  With them each
    subject's warp runs only its own ceil(len / col_pass) passes, and the
    blocks start from the grid's end, longest subjects first (csrc/sw_col.cu);
    the scores are those without.  The emitted H/F is then unspecified
    at the columns past a subject's own passes: no score reads them, since
    the next chunk runs the same passes and a pass's left edge lies in the
    pass before.  The plain version emits every column.
    """
    if take_init != (state_in is not None):
        raise ValueError("take_init must be set exactly when state_in is given")
    T, L, g, nsl = tiles.shape
    if (g, nsl) != (G, NSL) or L % LC:
        raise ValueError(f"col tiles must be [T, L % {LC} == 0, {G}, {NSL}], got {tuple(tiles.shape)}")
    if tiles.device.type == "cpu":
        cuda_lib.count(score_bucket_col, exact, plain=True)
        return score_bucket_col_plain(tiles, query, matrix_flat, params, state_in, emit_state,
                                      exact)
    nq_pad, gop, gex = _params(params)
    cuda_lib.check_query_rows(query, nq_pad, tiles.device)
    _count_passes(score_bucket_col, lengths, tiles, 1)
    out, state = cuda_lib.launch_col(
        score_bucket_col, "sw_col_kernel", tiles, query[:nq_pad].view(1, nq_pad), matrix_flat,
        gop, gex, state_in=state_in, emit_state=emit_state, sat=sw_cell.sat_state(exact) or 0,
        lengths=_lengths_dev(lengths),
    )
    return (out[0], state) if emit_state else out[0]


score_bucket_col.launches = score_bucket_col.launches16 = 0
score_bucket_col.plain_calls = score_bucket_col.plain_calls16 = 0
score_bucket_col.col_warp_passes = score_bucket_col.col_bucket_passes = 0


def padded_rows(nq: int, unroll: int | None = None) -> int:
    """Rows the col kernel runs for ``nq`` query rows: ``nq`` rounded up to
    a multiple of ``unroll``, at least one granule."""
    unroll = DEFAULT_UNROLL if unroll is None else unroll
    return max(unroll, -(-nq // unroll) * unroll)


def pad_query_chunk(codes, unroll: int | None = None, pad: int | None = None):
    """Pad one query chunk to [NQC] and its row count to a multiple of
    ``unroll`` (at least one granule), returning (qpad [NQC] int32 numpy,
    nq_pad).  ``pad``: padding code (UNKNOWN classic, 25 full-blosum)."""
    if len(codes) > NQC:
        raise ValueError(f"query chunk of {len(codes)} rows exceeds NQC={NQC}")
    qpad, nq = prepare_query(codes, qcap=NQC, pad=pad)
    return qpad, padded_rows(nq, unroll)


def col_group_tiles(T: int, L: int, rows: int, nchunks: int, budget: int,
                    exact: bool = True) -> int:
    """Tiles per group of ``score_bucket_col_any_query``: all T for a
    single chunk; else as many as keep one group's device state within
    ``budget``: its carry (H and F, 8 bytes a tile char) and the col
    kernel's boundary columns (H and E of each subject for ``rows`` query
    rows, int32, int16 when not ``exact``).  At least one."""
    if nchunks == 1:
        return max(1, T)
    per_tile = 8 * L * G * NSL + cuda_lib.col_boundary_bytes(1, rows, 0 if exact else 1)
    return max(1, min(T, budget // per_tile))


def score_bucket_col_any_query(tiles, codes, matrix_flat, gop: int, gex: int,
                               unroll: int | None = None, pad: int | None = None,
                               temp_bytes: int | None = None, exact: bool = True,
                               lengths: ColLengths | None = None):
    """Score a col bucket against a query of any length: NQC-row chunks
    with the H/F carry between them, tiles in groups whose carry and
    boundary columns fit ``temp_bytes`` (default ``cuda_lib.TEMP_BYTES``;
    ``col_group_tiles``); ``exact=False`` runs every chunk with int16
    state; ``lengths``: the tiles' subject lengths (``score_bucket_col``),
    or None.

    ``codes``: encoded query (host array).  Returns f32 [T, 4096] on the
    tiles' device.  Each group runs its whole chunk loop before the next
    group starts; the caching allocator reuses the previous group's carry
    memory, so at most two carries of one group are live.
    """
    unroll = DEFAULT_UNROLL if unroll is None else unroll
    dev = tiles.device
    n = len(codes)
    chunks = [codes[s : s + NQC] for s in range(0, n, NQC)] or [codes]
    qps = []
    for chunk in chunks:
        qpad, nq_pad = pad_query_chunk(chunk, unroll, pad=pad)
        qps.append((cuda_lib.to_device(qpad, dev), (nq_pad, gop, gex, 0)))

    T, L = tiles.shape[0], tiles.shape[1]
    budget = cuda_lib.TEMP_BYTES if temp_bytes is None else temp_bytes
    tc = col_group_tiles(T, L, max(p[1][0] for p in qps), len(chunks), budget, exact)
    parts = []
    for t0 in range(0, T, tc):
        sub = tiles[t0 : t0 + tc]
        lens = None if lengths is None else lengths[t0 : t0 + tc]
        best = None
        state = None
        for k, (qpad, params) in enumerate(qps):
            emit = k + 1 < len(qps)
            res = score_bucket_col(
                sub, qpad, matrix_flat, params, state_in=state,
                take_init=state is not None, emit_state=emit, exact=exact, lengths=lens,
            )
            scores, state = res if emit else (res, None)
            best = scores if best is None else torch.maximum(best, scores)
        parts.append(best)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _flat_contract(tiles, queries, params, rtot):
    """Check the flat-pool contract that B5 and B6 share; returns
    (rtot, nqp per slot).  Every slot runs nqp rows, a multiple of the
    unroll, from the top of its query block."""
    if tiles.dim() != 4:
        raise ValueError(f"col tiles must be [T, L, {G}, {NSL}], got {tuple(tiles.shape)}")
    T, L, g, nsl = tiles.shape
    if (g, nsl) != (G, NSL) or L % LC:
        raise ValueError(f"col tiles must be [T, L % {LC} == 0, {G}, {NSL}], got {tuple(tiles.shape)}")
    if queries.dim() != 2 or queries.shape[0] == 0:
        raise ValueError(f"queries must be [S >= 1, W], got {tuple(queries.shape)}")
    S, W = queries.shape
    rtot = NQC if rtot is None else int(rtot)
    if W > rtot:
        raise ValueError(f"query block width {W} exceeds the pool of {rtot} rows")
    if len(params) < 4 + S:
        raise ValueError(f"params hold {len(params)} entries, expected 4 + {S}")
    nqps = [int(params[4 + s]) for s in range(S)]
    for s, n in enumerate(nqps):
        if n < 0 or n % DEFAULT_UNROLL:
            raise ValueError(f"slot {s}: {n} rows is not a multiple of the unroll {DEFAULT_UNROLL}")
        if n > W:
            raise ValueError(f"slot {s}: {n} rows exceed the query block of {W}")
    return rtot, nqps


def score_bucket_col_flat_plain(tiles, queries, matrix_flat, params, exact: bool = True):
    """Plain PyTorch version of the flat and fused col kernels: each slot
    swept alone over its nqp rows, f32 [S, T, 4096] (the pool layout
    places nothing here)."""
    gop, gex = int(params[1]), int(params[2])
    T, L, g, nsl = tiles.shape
    A = cuda_lib.alphabet_dim(matrix_flat)
    x, mat = tiles.reshape(T, L, g * nsl), matrix_flat.view(A, A)
    sat = sw_cell.sat_state(exact)
    return torch.stack([
        sweep_tiles_torch(x, queries[s, : int(params[4 + s])].tolist(), mat, gop, gex,
                          sat=sat)[0].float()
        for s in range(queries.shape[0])
    ])


def score_bucket_col_flat(tiles, queries, matrix_flat, params, offs, rtot=None,
                          exact: bool = True, lengths: ColLengths | None = None):
    """Scores f32 [S, T, 4096]: S flat-pool slots against a col bucket in
    one launch.

    ``tiles``: int8 [T, L, 32, 128] with L % LC == 0; ``queries``: int32
    [S, W <= rtot] padded with the pad code; ``params``: host ints [4 + S]
    = _, gop, gex, _, nqp_0.., each nqp a multiple of DEFAULT_UNROLL;
    ``offs``: slot s owns pool rows [offs[s], offs[s] + nqp_s), which must
    not overlap nor pass ``rtot`` (default NQC).  ``exact=False``: int16
    state saturating at ``sw_cell.SAT`` (``sw_cell.sat_match``), the
    boundary pool int16.  ``lengths``: as ``score_bucket_col``'s.
    """
    rtot, nqps = _flat_contract(tiles, queries, params, rtot)
    offs = tuple(int(o) for o in offs)
    if len(offs) != len(nqps):
        raise ValueError(f"{len(offs)} offsets for {len(nqps)} slots")
    if min(offs) < 0 or max(offs) >= rtot:
        raise ValueError(f"offsets {offs} outside the pool of {rtot} rows")
    spans = sorted((o, o + n) for o, n in zip(offs, nqps) if n)
    for a, b in spans:
        if b > rtot:
            raise ValueError(f"pool rows [{a}, {b}) pass the pool of {rtot} rows")
    for (_, b0), (a1, b1) in zip(spans, spans[1:]):
        if a1 < b0:
            raise ValueError(f"pool rows [{a1}, {b1}) overlap a slot ending at {b0}")
    if tiles.device.type == "cpu":
        cuda_lib.count(score_bucket_col_flat, exact, plain=True)
        return score_bucket_col_flat_plain(tiles, queries, matrix_flat, params, exact)
    _count_passes(score_bucket_col_flat, lengths, tiles, len(nqps))
    return cuda_lib.launch_col(
        score_bucket_col_flat, "sw_col_flat_kernel", tiles, queries, matrix_flat,
        int(params[1]), int(params[2]), slots=(nqps, offs, rtot),
        sat=sw_cell.sat_state(exact) or 0, lengths=_lengths_dev(lengths),
    )[0]


score_bucket_col_flat.launches = score_bucket_col_flat.launches16 = 0
score_bucket_col_flat.plain_calls = score_bucket_col_flat.plain_calls16 = 0
score_bucket_col_flat.col_warp_passes = score_bucket_col_flat.col_bucket_passes = 0


def score_bucket_col_flat_fused(tiles, queries, matrix_flat, params, rtot=None,
                                exact: bool = True, lengths: ColLengths | None = None):
    """Scores f32 [S, T, 4096]: the flat contract with the slots' rows
    packed without gaps (sum of nqp <= ``rtot``, a multiple of
    DEFAULT_UNROLL), slot s's boundary columns in rows [starts[s],
    starts[s + 1]) of one gapless pool of sum(nqp) rows.  ``exact``: as
    ``score_bucket_col_flat``; ``lengths``: as ``score_bucket_col``'s.
    """
    rtot, nqps = _flat_contract(tiles, queries, params, rtot)
    if rtot % DEFAULT_UNROLL:
        raise ValueError(f"pool of {rtot} rows is not a multiple of the unroll {DEFAULT_UNROLL}")
    if sum(nqps) > rtot:
        raise ValueError(f"slots of {sum(nqps)} rows exceed the pool of {rtot} rows")
    if tiles.device.type == "cpu":
        cuda_lib.count(score_bucket_col_flat_fused, exact, plain=True)
        return score_bucket_col_flat_plain(tiles, queries, matrix_flat, params, exact)
    starts = [0, *itertools.accumulate(nqps)]
    _count_passes(score_bucket_col_flat_fused, lengths, tiles, len(nqps))
    return cuda_lib.launch_col(
        score_bucket_col_flat_fused, "sw_col_fused_kernel", tiles, queries, matrix_flat,
        int(params[1]), int(params[2]), slots=(None, starts, starts[-1]),
        sat=sw_cell.sat_state(exact) or 0, lengths=_lengths_dev(lengths),
    )[0]


score_bucket_col_flat_fused.launches = score_bucket_col_flat_fused.launches16 = 0
score_bucket_col_flat_fused.plain_calls = score_bucket_col_flat_fused.plain_calls16 = 0
score_bucket_col_flat_fused.col_warp_passes = score_bucket_col_flat_fused.col_bucket_passes = 0
