"""Smith-Waterman local alignment scores in plain PyTorch, exact int32.

Recurrence (gop, gex <= 0: a gap of n columns scores gop + (n - 1) gex):
    E[i][j] = max(E[i][j-1] + gex, H[i][j-1] + gop)
    F[i][j] = max(F[i-1][j] + gex, H[i-1][j] + gop)
    H[i][j] = max(0, H[i-1][j-1] + s(q[i], d[j]), E[i][j], F[i][j])
    score   = max over i, j of H[i][j]

One query row a step, vectorised over a block of subjects [P, L].  Along
the row E is an exclusive running maximum: with Ht = max(0, diagonal,
F), E[j] = max_{k<j}(Ht[k] + gop + (j - k - 1) gex), which is exact since
opening a gap from a cell that an E made never beats extending that gap.
Subjects and queries are padded at their ends with code 20, which scores
below 0 against everything in every matrix of ``scoring`` and so never
raises a score.
"""

from __future__ import annotations

import numpy as np
import torch

from .scoring import matrix

#: Minus infinity for F, far from int32's end after any number of rows.
NEG = -(1 << 24)
PAD = 20
#: Cells of one block: subjects x padded length.
BLOCK_CELLS = 1 << 24


def _sweep(rows: int, sub_row, P: int, L: int, device, gop: int, gex: int) -> torch.Tensor:
    """Best scores int32 [P] of ``rows`` query rows over a block [P, L];
    ``sub_row(i)`` gives the substitution scores [P, L] of row i."""
    hbuf = torch.zeros((P, L + 1), dtype=torch.int32, device=device)  # column 0 stays 0
    F = torch.full((P, L), NEG, dtype=torch.int32, device=device)
    best = torch.zeros((P, L), dtype=torch.int32, device=device)
    j = torch.arange(L, dtype=torch.int32, device=device)
    c1 = gop - (j + 1) * gex
    c2 = (j * gex)[1:]
    for i in range(rows):
        F = torch.maximum(F + gex, hbuf[:, 1:] + gop)
        ht = hbuf[:, :-1] + sub_row(i)
        torch.maximum(ht, F, out=ht)
        ht.clamp_min_(0)
        run = torch.cummax(ht + c1, dim=1).values
        hbuf[:, 1] = ht[:, 0]
        hbuf[:, 2:] = torch.maximum(ht[:, 1:], run[:, :-1] + c2)
        torch.maximum(best, hbuf[:, 1:], out=best)
    return best.amax(dim=1)


class Scorer:
    """Scores of queries against a database held on ``device``: ``chars``
    int8, ``offsets`` [n + 1] and ``lengths`` [n] (ascending) in the
    database format, under the substitution matrix ``matrix_name`` and a
    gap of n columns scoring ``gop + (n - 1) gex`` (both <= 0)."""

    def __init__(self, chars, offsets, lengths, device, matrix_name: str, gop: int, gex: int):
        self.device = torch.device(device)
        self.chars = torch.as_tensor(np.asarray(chars)).to(self.device)
        self.offsets = np.asarray(offsets, np.int64)
        self.lengths = np.asarray(lengths, np.int64)
        self.gop, self.gex = gop, gex
        m = torch.as_tensor(matrix(matrix_name))
        if m[20].max() >= 0:
            raise ValueError(f"{matrix_name}: code 20 must score below 0 to pad")
        self.m8 = m.to(torch.int8).to(self.device)
        self.m32 = m.reshape(-1).to(self.device)

    def _subjects(self, ids: np.ndarray) -> torch.Tensor:
        """Codes int64 [P, L] of entries ``ids``, padded with PAD."""
        lens = torch.as_tensor(self.lengths[ids], device=self.device)
        L = max(1, int(lens.max()))
        j = torch.arange(L, device=self.device)
        offs = torch.as_tensor(self.offsets[ids], device=self.device)
        idx = (offs[:, None] + j).clamp_max(self.chars.numel() - 1)
        codes = self.chars[idx].long()
        return torch.where(j < lens[:, None], codes, PAD)

    def _blocks(self, ids: np.ndarray):
        """(start, run) of the runs of ``ids`` (ascending length) of at most
        BLOCK_CELLS cells."""
        a, n = 0, len(ids)
        while a < n:
            b = min(n, a + max(1, BLOCK_CELLS // int(self.lengths[ids[a]])))
            while b - a > 1 and (b - a) * int(self.lengths[ids[b - 1]]) > BLOCK_CELLS:
                b = a + max(1, BLOCK_CELLS // int(self.lengths[ids[b - 1]]))
            yield a, ids[a:b]
            a = b

    def database(self, queries, ids=None) -> np.ndarray:
        """Scores int64 [len(queries), len(ids)] of every query against the
        entries ``ids`` (ascending; default every entry)."""
        ids = np.arange(len(self.lengths)) if ids is None else np.asarray(ids, np.int64)
        out = np.zeros((len(queries), len(ids)), np.int64)
        for a, block in self._blocks(ids):
            subj = self._subjects(block)
            prof = self.m8[:, subj]  # [21, P, L] scores of each letter
            P, L = subj.shape
            for qi, q in enumerate(queries):
                q = np.asarray(q, np.int64)
                best = _sweep(len(q), lambda i: prof[int(q[i])], P, L, self.device,
                              self.gop, self.gex)
                out[qi, a : a + len(block)] = best.cpu().numpy()
        return out

    def pairs(self, query_codes, subject_ids) -> np.ndarray:
        """Scores int64 [len(pairs)] of each (query codes, entry id) pair."""
        order = sorted(range(len(subject_ids)), key=lambda k: len(query_codes[k]))
        out = np.zeros(len(subject_ids), np.int64)
        a = 0
        while a < len(order):
            b = min(len(order), a + 64)
            group = order[a:b]
            ids = np.asarray([subject_ids[k] for k in group], np.int64)
            subj = self._subjects(ids)
            m = max(len(query_codes[k]) for k in group)
            qmat = np.full((len(group), m), PAD, np.int64)
            for r, k in enumerate(group):
                qmat[r, : len(query_codes[k])] = query_codes[k]
            qdev = torch.as_tensor(qmat, device=self.device) * 21
            P, L = subj.shape
            best = _sweep(m, lambda i: self.m32[qdev[:, i : i + 1] + subj], P, L, self.device,
                          self.gop, self.gex)
            out[group] = best.cpu().numpy()
            a = b
        return out


def top_n(scores: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The ``n`` best (scores, ids) of one query's scores over the
    database: descending score, then ascending id."""
    order = np.lexsort((np.arange(len(scores)), -scores))[:n]
    return scores[order], order
