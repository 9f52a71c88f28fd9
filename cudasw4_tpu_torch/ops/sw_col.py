"""Column-layout scoring for long subjects, with the H/F carry between
query chunks (the counterpart of cudasw4_tpu/ops/sw_pallas_col.py:
score_bucket_pallas_col, pad_query_chunk, score_bucket_col_any_query).

The kernel is ``sw_col_kernel`` in csrc/sw_tiles.cu (its note gives the
design and the bound on the H100).  ``score_bucket_col`` keeps the TPU
kernel's contract: one query chunk of ``nq_pad`` rows (at most NQC) against
cell-layout tiles whose L is a multiple of LC, optionally starting from the
previous chunk's bottom-row H/F (``state_in``) and returning its own
(``emit_state``).  Queries longer than NQC run chunk by chunk through
``score_bucket_col_any_query``; per-chunk scores combine by max.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .sw_cell import DEFAULT_UNROLL, G, NSL
from .sw_row import prepare_query
from .sw_torch import sweep_tiles_torch

#: Subject positions per column chunk: every col bucket's L is a multiple.
LC = 128

#: Query rows per col call; longer queries chunk with the H/F carry.
NQC = 3072

#: Device-memory budget for one tile group's carry state (bottom-row H and
#: F, 8 bytes per tile char).  Buckets whose carry would exceed it run the
#: query-chunk loop one tile group at a time.
COL_CARRY_TEMP_BYTES = 1 << 30


def _params(params):
    return int(params[0]), int(params[1]), int(params[2])


def score_bucket_col_plain(tiles, query, matrix_flat, params, state_in=None,
                           emit_state: bool = False):
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
        tiles.reshape(T, L, g * nsl), rows, matrix_flat.view(A, A), gop, gex, h0, f0
    )
    scores = best.float()
    if emit_state:
        return scores, (H.reshape(T, L, g, nsl), F.reshape(T, L, g, nsl))
    return scores


def score_bucket_col(tiles, query, matrix_flat, params, state_in=None,
                     take_init: bool = False, emit_state: bool = False):
    """Scores f32 [T, 4096] = per-subject max over this query chunk's rows.

    ``tiles``: int8 [T, L, 32, 128] with L % LC == 0; ``query``: int32
    [NQC] chunk padded with the pad code; ``params``: host ints
    (nq_pad, gop, gex, _), nq_pad the rows to run; ``state_in``: (hrow,
    frow) int32 [T, L, 32, 128] from the previous chunk, given exactly when
    ``take_init``.  With ``emit_state`` also returns (hrow, frow): the
    last row's H/F, the next chunk's ``state_in``.
    """
    if take_init != (state_in is not None):
        raise ValueError("take_init must be set exactly when state_in is given")
    T, L, g, nsl = tiles.shape
    if (g, nsl) != (G, NSL) or L % LC:
        raise ValueError(f"col tiles must be [T, L % {LC} == 0, {G}, {NSL}], got {tuple(tiles.shape)}")
    if tiles.device.type == "cpu":
        score_bucket_col.plain_calls += 1
        return score_bucket_col_plain(tiles, query, matrix_flat, params, state_in, emit_state)
    out, state = cuda_lib.launch(score_bucket_col, "sw_col_kernel", tiles, query,
                                 matrix_flat, params, state_in)
    return (out, state) if emit_state else out


score_bucket_col.launches = 0
score_bucket_col.plain_calls = 0


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


def score_bucket_col_any_query(tiles, codes, matrix_flat, gop: int, gex: int,
                               unroll: int | None = None, pad: int | None = None,
                               temp_bytes: int | None = None):
    """Score a col bucket against a query of any length: NQC-row chunks
    with the H/F carry between them, tiles in groups whose carry fits
    ``temp_bytes`` (default COL_CARRY_TEMP_BYTES).

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

    T, L, g, nsl = tiles.shape
    budget = COL_CARRY_TEMP_BYTES if temp_bytes is None else temp_bytes
    per_tile_state = 2 * L * g * nsl * 4
    tc = max(1, T) if len(chunks) == 1 else max(1, min(T, budget // per_tile_state))
    parts = []
    for t0 in range(0, T, tc):
        sub = tiles[t0 : t0 + tc]
        best = None
        state = None
        for k, (qpad, params) in enumerate(qps):
            emit = k + 1 < len(qps)
            res = score_bucket_col(
                sub, qpad, matrix_flat, params, state_in=state,
                take_init=state is not None, emit_state=emit,
            )
            scores, state = res if emit else (res, None)
            best = scores if best is None else torch.maximum(best, scores)
        parts.append(best)
    return parts[0] if len(parts) == 1 else torch.cat(parts)
