"""Plain PyTorch Smith-Waterman scorer over packed tiles (the counterpart of
cudasw4_tpu/ops/sw_jax.py::score_tiles_jnp).

Every kernel module of the port builds its plain version on this file.  It
is the CPU path of the engine and the yardstick the CUDA kernels are held
against on the card; it is never the scoring path on the GPU.

Formulation (one query row per step, vectorised over [T, L, NS], int32):
    F    = max(F + gex, H + gop)                       # gap along the query
    Ht   = relu(max(shift_j(H) + sub, F))              # H without E
    E[j] = max_{k<j}(Ht[k] + gop + (j-k-1)*gex)        # exact lazy-gap scan
         = excl_cummax_j(Ht + gop - (k+1)*gex) + j*gex
    H    = max(Ht, E)
The E identity is exact because a gap extended from an E-derived H never
beats extending the gap that produced it (gop <= gex <= 0).
"""

from __future__ import annotations

import torch

#: -inf stand-in for F and E; safe from int32 underflow across adds.
NEG = -(1 << 24)


def sweep_tiles_torch(tiles, rows, matrix, gop: int, gex: int, h0=None, f0=None):
    """Advance the DP over the query ``rows`` (int codes, host sequence).

    ``tiles``: int8 [T, L, NS]; ``matrix``: int [A, A] on the tiles' device;
    ``h0``/``f0``: int32 [T, L, NS] H/F of the row above the first row
    (None: H = 0, F = -inf, the top of the DP matrix).  Returns
    (best int32 [T, NS], H, F), where H/F are the last row's state.
    """
    T, L, NS = tiles.shape
    dev = tiles.device
    mat = matrix.to(device=dev, dtype=torch.int32)
    x = tiles.long()
    j = torch.arange(L, device=dev, dtype=torch.int32).view(1, L, 1)
    c1 = gop - (j + 1) * gex
    c2 = j * gex
    H = torch.zeros((T, L, NS), dtype=torch.int32, device=dev) if h0 is None else h0
    F = torch.full((T, L, NS), NEG, dtype=torch.int32, device=dev) if f0 is None else f0
    best = torch.zeros((T, NS), dtype=torch.int32, device=dev)
    lead = torch.full((T, 1, NS), NEG, dtype=torch.int32, device=dev)
    zero = torch.zeros((T, 1, NS), dtype=torch.int32, device=dev)
    for qc in rows:
        sub = mat[int(qc)][x]
        F = torch.maximum(F + gex, H + gop)
        hdiag = torch.cat([zero, H[:, :-1]], dim=1)
        ht = torch.clamp_min(torch.maximum(hdiag + sub, F), 0)
        s = torch.cummax(ht + c1, dim=1).values
        E = torch.cat([lead, s[:, :-1]], dim=1) + c2
        H = torch.maximum(ht, E)
        best = torch.maximum(best, H.amax(dim=1))
    return best, H, F


def score_tiles_torch(tiles, query, matrix, gop: int, gex: int, nq: int):
    """Scores f32 [T, NS] for one query against all tiles of a bucket.

    ``tiles``: int8 [T, L, NS] position-major subject codes; ``query``: int
    codes (tensor or array), of which the first ``nq`` rows are real;
    ``matrix``: int [A, A].  Padded query rows are never walked.
    """
    rows = query[:nq]
    if isinstance(rows, torch.Tensor):
        rows = rows.tolist()
    best, _, _ = sweep_tiles_torch(tiles, rows, matrix, gop, gex)
    return best.float()
