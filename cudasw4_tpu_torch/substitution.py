"""Substitution matrices and scoring configuration (the port's own copy of
cudasw4_tpu/substitution.py).

Standard public BLOSUM45/50/62/80 matrices in NCBI amino-acid order
(A R N D C Q E G H I L K M F P S T W Y V), in two flavours:

* ``*_20`` (dim 21): the 20 standard letters plus one catch-all "other"
  letter whose row/column is a constant ``low`` penalty.  This is the
  default scoring model of the reference engine
  (the reference's src/types.hpp:29-201).
* full (dim 25): the 20 letters plus ambiguity codes B, J, Z, X and the
  stop ``*`` (the reference's src/types.hpp:205-396), selectable like the
  reference's CAN_USE_FULL_BLOSUM build.

Gap defaults per matrix follow the reference CLI
(the reference's src/options.cpp:178-194): blosum45/50 -> gop=-13 gex=-2,
blosum62 -> gop=-11 gex=-1, blosum80 -> gop=-10 gex=-1.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

from .constants import ALPHABET_SIZE


class BlosumType(enum.Enum):
    BLOSUM45 = "blosum45"
    BLOSUM50 = "blosum50"
    BLOSUM62 = "blosum62"
    BLOSUM80 = "blosum80"
    BLOSUM45_20 = "blosum45_20"
    BLOSUM50_20 = "blosum50_20"
    BLOSUM62_20 = "blosum62_20"
    BLOSUM80_20 = "blosum80_20"


# 20x20 cores, NCBI order: A R N D C Q E G H I L K M F P S T W Y V
_BLOSUM45_CORE = """
 5 -2 -1 -2 -1 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -2 -2  0
-2  7  0 -1 -3  1  0 -2  0 -3 -2  3 -1 -2 -2 -1 -1 -2 -1 -2
-1  0  6  2 -2  0  0  0  1 -2 -3  0 -2 -2 -2  1  0 -4 -2 -3
-2 -1  2  7 -3  0  2 -1  0 -4 -3  0 -3 -4 -1  0 -1 -4 -2 -3
-1 -3 -2 -3 12 -3 -3 -3 -3 -3 -2 -3 -2 -2 -4 -1 -1 -5 -3 -1
-1  1  0  0 -3  6  2 -2  1 -2 -2  1  0 -4 -1  0 -1 -2 -1 -3
-1  0  0  2 -3  2  6 -2  0 -3 -2  1 -2 -3  0  0 -1 -3 -2 -3
 0 -2  0 -1 -3 -2 -2  7 -2 -4 -3 -2 -2 -3 -2  0 -2 -2 -3 -3
-2  0  1  0 -3  1  0 -2 10 -3 -2 -1  0 -2 -2 -1 -2 -3  2 -3
-1 -3 -2 -4 -3 -2 -3 -4 -3  5  2 -3  2  0 -2 -2 -1 -2  0  3
-1 -2 -3 -3 -2 -2 -2 -3 -2  2  5 -3  2  1 -3 -3 -1 -2  0  1
-1  3  0  0 -3  1  1 -2 -1 -3 -3  5 -1 -3 -1 -1 -1 -2 -1 -2
-1 -1 -2 -3 -2  0 -2 -2  0  2  2 -1  6  0 -2 -2 -1 -2  0  1
-2 -2 -2 -4 -2 -4 -3 -3 -2  0  1 -3  0  8 -3 -2 -1  1  3  0
-1 -2 -2 -1 -4 -1  0 -2 -2 -2 -3 -1 -2 -3  9 -1 -1 -3 -3 -3
 1 -1  1  0 -1  0  0  0 -1 -2 -3 -1 -2 -2 -1  4  2 -4 -2 -1
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -1 -1  2  5 -3 -1  0
-2 -2 -4 -4 -5 -2 -3 -2 -3 -2 -2 -2 -2  1 -3 -4 -3 15  3 -3
-2 -1 -2 -2 -3 -1 -2 -3  2  0  0 -1  0  3 -3 -2 -1  3  8 -1
 0 -2 -3 -3 -1 -3 -3 -3 -3  3  1 -2  1  0 -3 -1  0 -3 -1  5
"""

_BLOSUM50_CORE = """
 5 -2 -1 -2 -1 -1 -1  0 -2 -1 -2 -1 -1 -3 -1  1  0 -3 -2  0
-2  7 -1 -2 -4  1  0 -3  0 -4 -3  3 -2 -3 -3 -1 -1 -3 -1 -3
-1 -1  7  2 -2  0  0  0  1 -3 -4  0 -2 -4 -2  1  0 -4 -2 -3
-2 -2  2  8 -4  0  2 -1 -1 -4 -4 -1 -4 -5 -1  0 -1 -5 -3 -4
-1 -4 -2 -4 13 -3 -3 -3 -3 -2 -2 -3 -2 -2 -4 -1 -1 -5 -3 -1
-1  1  0  0 -3  7  2 -2  1 -3 -2  2  0 -4 -1  0 -1 -1 -1 -3
-1  0  0  2 -3  2  6 -3  0 -4 -3  1 -2 -3 -1 -1 -1 -3 -2 -3
 0 -3  0 -1 -3 -2 -3  8 -2 -4 -4 -2 -3 -4 -2  0 -2 -3 -3 -4
-2  0  1 -1 -3  1  0 -2 10 -4 -3  0 -1 -1 -2 -1 -2 -3  2 -4
-1 -4 -3 -4 -2 -3 -4 -4 -4  5  2 -3  2  0 -3 -3 -1 -3 -1  4
-2 -3 -4 -4 -2 -2 -3 -4 -3  2  5 -3  3  1 -4 -3 -1 -2 -1  1
-1  3  0 -1 -3  2  1 -2  0 -3 -3  6 -2 -4 -1  0 -1 -3 -2 -3
-1 -2 -2 -4 -2  0 -2 -3 -1  2  3 -2  7  0 -3 -2 -1 -1  0  1
-3 -3 -4 -5 -2 -4 -3 -4 -1  0  1 -4  0  8 -4 -3 -2  1  4 -1
-1 -3 -2 -1 -4 -1 -1 -2 -2 -3 -4 -1 -3 -4 10 -1 -1 -4 -3 -3
 1 -1  1  0 -1  0 -1  0 -1 -3 -3  0 -2 -3 -1  5  2 -4 -2 -2
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  2  5 -3 -2  0
-3 -3 -4 -5 -5 -1 -3 -3 -3 -3 -2 -3 -1  1 -4 -4 -3 15  2 -3
-2 -1 -2 -3 -3 -1 -2 -3  2 -1 -1 -2  0  4 -3 -2 -2  2  8 -1
 0 -3 -3 -4 -1 -3 -3 -4 -4  4  1 -3  1 -1 -3 -2  0 -3 -1  5
"""

_BLOSUM62_CORE = """
 4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0
-1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3
-2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3
-2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3
 0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1
-1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2
-1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2
 0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3
-2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3
-1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3
-1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1
-1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2
-1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1
-2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1
-1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2
 1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0
-3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3
-2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1
 0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4
"""

_BLOSUM80_CORE = """
 5 -2 -2 -2 -1 -1 -1  0 -2 -2 -2 -1 -1 -3 -1  1  0 -3 -2  0
-2  6 -1 -2 -4  1 -1 -3  0 -3 -3  2 -2 -4 -2 -1 -1 -4 -3 -3
-2 -1  6  1 -3  0 -1 -1  0 -4 -4  0 -3 -4 -3  0  0 -4 -3 -4
-2 -2  1  6 -4 -1  1 -2 -2 -4 -5 -1 -4 -4 -2 -1 -1 -6 -4 -4
-1 -4 -3 -4  9 -4 -5 -4 -4 -2 -2 -4 -2 -3 -4 -2 -1 -3 -3 -1
-1  1  0 -1 -4  6  2 -2  1 -3 -3  1  0 -4 -2  0 -1 -3 -2 -3
-1 -1 -1  1 -5  2  6 -3  0 -4 -4  1 -2 -4 -2  0 -1 -4 -3 -3
 0 -3 -1 -2 -4 -2 -3  6 -3 -5 -4 -2 -4 -4 -3 -1 -2 -4 -4 -4
-2  0  0 -2 -4  1  0 -3  8 -4 -3 -1 -2 -2 -3 -1 -2 -3  2 -4
-2 -3 -4 -4 -2 -3 -4 -5 -4  5  1 -3  1 -1 -4 -3 -1 -3 -2  3
-2 -3 -4 -5 -2 -3 -4 -4 -3  1  4 -3  2  0 -3 -3 -2 -2 -2  1
-1  2  0 -1 -4  1  1 -2 -1 -3 -3  5 -2 -4 -1 -1 -1 -4 -3 -3
-1 -2 -3 -4 -2  0 -2 -4 -2  1  2 -2  6  0 -3 -2 -1 -2 -2  1
-3 -4 -4 -4 -3 -4 -4 -4 -2 -1  0 -4  0  6 -4 -3 -2  0  3 -1
-1 -2 -3 -2 -4 -2 -2 -3 -3 -4 -3 -1 -3 -4  8 -1 -2 -5 -4 -3
 1 -1  0 -1 -2  0  0 -1 -1 -3 -3 -1 -2 -3 -1  5  1 -4 -2 -2
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -2 -1 -1 -2 -2  1  5 -4 -2  0
-3 -4 -4 -6 -3 -3 -4 -4 -3 -3 -2 -4 -2  0 -5 -4 -4 11  2 -3
-2 -3 -3 -4 -3 -2 -3 -4  2 -2 -2 -3 -2  3 -4 -2 -2  2  7 -2
 0 -3 -4 -4 -1 -3 -3 -4 -4  3  1 -3  1 -1 -3 -2  0 -3 -2  4
"""

# Extension rows/cols for the 25-dim full matrices, order B J Z X *.
# ext[m] rows are the scores of B/J/Z/X/* against A..V (20 entries), then the
# 5x5 tail block among (B J Z X *) themselves.
_FULL_EXT = {
    "blosum45": (
        [
            [-1, -1, 5, 6, -2, 0, 1, -1, 0, -3, -3, 0, -2, -3, -2, 0, 0, -4, -2, -3],
            [-1, -3, -3, -3, -2, -2, -3, -4, -2, 4, 4, -3, 2, 1, -3, -2, -1, -2, 0, 2],
            [-1, 1, 0, 1, -3, 4, 5, -2, 0, -3, -2, 1, -1, -3, -1, 0, -1, -2, -2, -3],
            [-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1],
            [-5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5],
        ],
        [
            [5, -3, 1, -1, -5],
            [-3, 4, -2, -1, -5],
            [1, -2, 5, -1, -5],
            [-1, -1, -1, -1, -5],
            [-5, -5, -5, -5, 1],
        ],
    ),
    "blosum50": (
        [
            [-2, -1, 5, 6, -3, 0, 1, -1, 0, -4, -4, 0, -3, -4, -2, 0, 0, -5, -3, -3],
            [-2, -3, -4, -4, -2, -3, -3, -4, -3, 4, 4, -3, 2, 1, -3, -3, -1, -2, -1, 2],
            [-1, 0, 0, 1, -3, 4, 5, -2, 0, -3, -3, 1, -1, -4, -1, 0, -1, -2, -2, -3],
            [-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1],
            [-5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5],
        ],
        [
            [6, -4, 1, -1, -5],
            [-4, 4, -3, -1, -5],
            [1, -3, 5, -1, -5],
            [-1, -1, -1, -1, -5],
            [-5, -5, -5, -5, 1],
        ],
    ),
    "blosum62": (
        [
            [-2, -1, 4, 4, -3, 0, 1, -1, 0, -3, -4, 0, -3, -3, -2, 0, -1, -4, -3, -3],
            [-1, -2, -3, -3, -1, -2, -3, -4, -3, 3, 3, -3, 2, 0, -3, -2, -1, -2, -1, 2],
            [-1, 0, 0, 1, -3, 4, 4, -2, 0, -3, -3, 1, -1, -3, -1, 0, -1, -2, -2, -2],
            [-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1],
            [-4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4],
        ],
        [
            [4, -3, 0, -1, -4],
            [-3, 3, -3, -1, -4],
            [0, -3, 4, -1, -4],
            [-1, -1, -1, -1, -4],
            [-4, -4, -4, -4, 1],
        ],
    ),
    "blosum80": (
        [
            [-2, -1, 5, 5, -4, 0, 1, -1, -1, -4, -4, -1, -3, -4, -2, 0, -1, -5, -3, -4],
            [-2, -3, -4, -5, -2, -3, -4, -5, -4, 3, 3, -3, 2, 0, -4, -3, -1, -3, -2, 2],
            [-1, 0, 0, 1, -4, 4, 5, -3, 0, -4, -3, 1, -1, -4, -2, 0, -1, -3, -3, -3],
            [-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1],
            [-6, -6, -6, -6, -6, -6, -6, -6, -6, -6, -6, -6, -6, -6, -6, -6, -6, -6, -6, -6],
        ],
        [
            [5, -4, 0, -1, -6],
            [-4, 3, -3, -1, -6],
            [0, -3, 5, -1, -6],
            [-1, -1, -1, -1, -6],
            [-6, -6, -6, -6, 1],
        ],
    ),
}

_LOW = {"blosum45": -5, "blosum50": -5, "blosum62": -4, "blosum80": -6}
_GAP_DEFAULTS = {
    "blosum45": (-13, -2),
    "blosum50": (-13, -2),
    "blosum62": (-11, -1),
    "blosum80": (-10, -1),
}


def _parse_core(text: str) -> np.ndarray:
    rows = [[int(v) for v in line.split()] for line in text.strip().splitlines()]
    m = np.array(rows, dtype=np.int32)
    assert m.shape == (20, 20)
    assert np.array_equal(m, m.T), "substitution core must be symmetric"
    return m


def _make_20(core: np.ndarray, low: int) -> np.ndarray:
    """Build the 21x21 matrix: core plus an all-``low`` other row/col."""
    m = np.full((ALPHABET_SIZE, ALPHABET_SIZE), low, dtype=np.int32)
    m[:20, :20] = core
    return m


def _make_full(core: np.ndarray, name: str) -> np.ndarray:
    ext_rows, tail = _FULL_EXT[name]
    m = np.zeros((25, 25), dtype=np.int32)
    m[:20, :20] = core
    ext = np.array(ext_rows, dtype=np.int32)  # [5, 20]
    m[20:, :20] = ext
    m[:20, 20:] = ext.T
    m[20:, 20:] = np.array(tail, dtype=np.int32)
    assert np.array_equal(m, m.T), f"{name} full matrix must be symmetric"
    return m


def _make_full26(core: np.ndarray, name: str) -> np.ndarray:
    """The engine's full-blosum scoring matrix: the 25-dim table
    (A..V, B, J, Z, X, *) plus a 26th dedicated padding code whose
    row/column is the constant ``low`` penalty.

    The reference scores only real subject positions (per-sequence exact
    lengths), so its full mode can let code 20 mean 'B'
    (the reference's src/types.hpp:205-396 with ConvertAA_20).  Our tiles
    score the padded extent, so padding must be a code whose row can
    never raise a local-alignment score — B's row has positive entries.
    Code 25 = padding (all ``low`` <= -4) resolves the round-1 limitation
    without dropping the mode.
    """
    m = np.full((26, 26), _LOW[name], dtype=np.int32)
    m[:25, :25] = _make_full(core, name)
    assert np.array_equal(m, m.T)
    assert (m[25] < 0).all()
    return m


_CORES = {
    "blosum45": _parse_core(_BLOSUM45_CORE),
    "blosum50": _parse_core(_BLOSUM50_CORE),
    "blosum62": _parse_core(_BLOSUM62_CORE),
    "blosum80": _parse_core(_BLOSUM80_CORE),
}

MATRICES_20 = {name: _make_20(core, _LOW[name]) for name, core in _CORES.items()}
MATRICES_FULL = {name: _make_full(c, name) for name, c in _CORES.items()}
MATRICES_FULL26 = {name: _make_full26(c, name) for name, c in _CORES.items()}


@dataclass(frozen=True)
class ScoringConfig:
    """Substitution matrix + affine gap penalties.

    ``gop`` is the score added when a gap is opened from a match state and
    ``gex`` when an existing gap is extended — both are non-positive, matching
    the reference recurrence E = max(E+gex, H+gop)
    (the reference's src/cudasw4.cuh:2331-2392).
    """

    blosum: BlosumType = BlosumType.BLOSUM62_20
    gop: int = -11
    gex: int = -1

    @property
    def base_name(self) -> str:
        return self.blosum.value.replace("_20", "")

    @property
    def is_full(self) -> bool:
        """Full-blosum mode (the reference's CAN_USE_FULL_BLOSUM build):
        a non-_20 BlosumType scores code 20 as 'B' via the 25-dim table
        instead of the constant ``low`` penalty."""
        return not self.blosum.value.endswith("_20")

    @property
    def matrix(self) -> np.ndarray:
        """The engine scoring matrix: 21x21 classic (codes 0..20, code 20
        = catch-all "other"/padding) or 26x26 full-blosum (codes 0..24 =
        A..V B J Z X *, code 25 = padding)."""
        if self.is_full:
            return MATRICES_FULL26[self.base_name]
        return MATRICES_20[self.base_name]

    @property
    def pad_code(self) -> int:
        """Alphabet code used for subject/query padding (can never raise
        a local-alignment score: its matrix row is all ``low``)."""
        return 25 if self.is_full else 20

    @property
    def alphabet_size(self) -> int:
        return self.matrix.shape[0]

    @property
    def full_matrix(self) -> np.ndarray:
        """The raw 25-dim reference table with B/J/Z/X/*
        (the reference's src/types.hpp:205-396)."""
        return MATRICES_FULL[self.base_name]


def make_scoring_config(
    blosum: BlosumType | str = BlosumType.BLOSUM62_20,
    gop: int | None = None,
    gex: int | None = None,
) -> ScoringConfig:
    """Build a ScoringConfig with matrix-dependent default gap penalties.

    String shorthands: ``"blosum62"`` (and the ``_20`` forms) select the
    classic 21-letter scoring; ``"blosum62_full"`` selects full-blosum
    mode (the 25-dim table with B/J/Z/X/*, the reference's
    CAN_USE_FULL_BLOSUM build — there, the plain name means the full
    table).  Passing a BlosumType enum uses the enum's own semantics
    (non-_20 enums are full).
    """
    if isinstance(blosum, str):
        name = blosum.lower()
        if not name.startswith("blosum"):
            raise ValueError(f"Unknown substitution matrix: {blosum}")
        if name.endswith("_full"):
            blosum = BlosumType(name[: -len("_full")])
        elif not name.endswith("_20"):
            blosum = BlosumType(name + "_20")
        else:
            blosum = BlosumType(name)
    base = blosum.value.replace("_20", "")
    dgop, dgex = _GAP_DEFAULTS[base]
    cfg = ScoringConfig(
        blosum=blosum,
        gop=dgop if gop is None else gop,
        gex=dgex if gex is None else gex,
    )
    # Sanity constraints shared with the scan-based DP formulation:
    # non-positive penalties (positive ones let scores diverge in any affine
    # DP) and extension no more expensive than opening (gex >= gop), which
    # the lazy-gap scan relies on.  All published matrix defaults satisfy
    # these; reject the pathological corner instead of silently mis-scoring.
    if cfg.gop > 0 or cfg.gex > 0:
        raise ValueError(f"gap penalties must be <= 0, got gop={cfg.gop} gex={cfg.gex}")
    if cfg.gex < cfg.gop:
        raise ValueError(
            f"gap extension ({cfg.gex}) must not be more expensive than "
            f"gap open ({cfg.gop})"
        )
    return cfg
