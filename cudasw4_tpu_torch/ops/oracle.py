"""Scalar Smith-Waterman oracle (the port's own copy of
cudasw4_tpu/ops/oracle.py; test and chip-check reference).

Plays the role of the reference's CPU verifier
``affine_local_DP_host_protein_blosum62_converted``
(the reference's src/cudasw4.cuh:2331-2392): a direct, obviously-correct
affine-gap local-alignment scorer used to validate the kernels.  Unlike
the reference it takes an arbitrary substitution matrix and gap penalties.

Recurrence (scores, all integers; gop/gex non-positive):
    E[i][j] = max(E[i][j-1] + gex, H[i][j-1] + gop)
    F[i][j] = max(F[i-1][j] + gex, H[i-1][j] + gop)
    H[i][j] = max(0, H[i-1][j-1] + sub(q[i-1], s[j-1]), E[i][j], F[i][j])
    score   = max over all i, j of H[i][j]
"""

from __future__ import annotations

import numpy as np

NEG_INF = -(10**7)


def sw_score_scalar(
    query: np.ndarray,
    subject: np.ndarray,
    matrix: np.ndarray,
    gop: int,
    gex: int,
) -> int:
    """Pure-python affine-gap local alignment score (slow, exact)."""
    q = np.asarray(query, dtype=np.int64)
    s = np.asarray(subject, dtype=np.int64)
    m, n = len(q), len(s)
    H_prev = np.zeros(n + 1, dtype=np.int64)
    F_prev = np.full(n + 1, NEG_INF, dtype=np.int64)
    best = 0
    for i in range(1, m + 1):
        H_cur = np.zeros(n + 1, dtype=np.int64)
        F_cur = np.full(n + 1, NEG_INF, dtype=np.int64)
        E = NEG_INF
        sub_row = matrix[q[i - 1]]
        for j in range(1, n + 1):
            E = max(E + gex, H_cur[j - 1] + gop)
            F = max(F_prev[j] + gex, H_prev[j] + gop)
            h = max(0, H_prev[j - 1] + sub_row[s[j - 1]], E, F)
            H_cur[j] = h
            F_cur[j] = F
            if h > best:
                best = h
        H_prev, F_prev = H_cur, F_cur
    return int(best)


def sw_score_rowvec(
    query: np.ndarray,
    subjects: np.ndarray,
    matrix: np.ndarray,
    gop: int,
    gex: int,
) -> np.ndarray:
    """Vectorised oracle: one query vs a batch of equal-length subjects.

    ``subjects``: int array [N, L] (padding letters score ``low`` and cannot
    raise the max, so padded batches give the same score as unpadded ones).
    Streams the query; per query row the E-dependency along the subject is
    resolved with the exact lazy-gap max-scan:
        E[i][j] = max_{k<j}( Ht[i][k] + gop + (j-k-1)*gex )
    (a length-1 gap costs gop alone; each extra column adds gex), where Ht
    is H computed without E — exact because opening a new gap from an
    E-derived H (cost gop <= 0 again) never beats extending the original.
    This is the same formulation ops/sw_torch.py uses, but in NumPy.
    """
    q = np.asarray(query, dtype=np.int64)
    subs = np.asarray(subjects, dtype=np.int64)
    n, L = subs.shape
    H = np.zeros((n, L), dtype=np.int64)
    F = np.full((n, L), NEG_INF, dtype=np.int64)
    M = np.zeros((n, L), dtype=np.int64)
    j_idx = np.arange(L, dtype=np.int64)
    c1 = gop - (j_idx + 1) * gex  # u[k] = Ht[k] + gop - (k+1)*gex
    c2 = j_idx * gex  # E[j] = excl_max_scan(u)[j] + j*gex
    for qc in q:
        sub = matrix[qc][subs]  # [n, L]
        F = np.maximum(F + gex, H + gop)
        Hdiag = np.concatenate([np.zeros((n, 1), dtype=np.int64), H[:, :-1]], axis=1)
        Ht = np.maximum(np.maximum(Hdiag + sub, F), 0)
        u = Ht + c1
        s = np.concatenate(
            [np.full((n, 1), NEG_INF, dtype=np.int64), np.maximum.accumulate(u, axis=1)[:, :-1]],
            axis=1,
        )
        E = s + c2
        H = np.maximum(Ht, E)
        np.maximum(M, H, out=M)
    return M.max(axis=1)
