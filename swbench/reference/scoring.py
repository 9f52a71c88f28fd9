"""Substitution matrices of the plain reference, one file each under
``matrices/<name>.txt``: 20 rows of the 20 x 20 core in the NCBI order
A R N D C Q E G H I L K M F P S T W Y V, then ``other <score>``, which
code 20 (any other letter, and the padding) scores against every letter.
A configuration names its matrix by the file's name, so a matrix is added
by adding a file."""

from __future__ import annotations

from pathlib import Path

import numpy as np

MATRICES = Path(__file__).resolve().parent / "matrices"


def names() -> list[str]:
    """The matrices the reference holds."""
    return sorted(p.stem for p in MATRICES.glob("*.txt"))


def matrix(name: str) -> np.ndarray:
    """The 21 x 21 int32 scoring matrix of ``matrices/<name>.txt``."""
    path = MATRICES / f"{name}.txt"
    if not path.is_file():
        raise ValueError(f"no substitution matrix {name!r} (have {names()})")
    rows, other = [], None
    for line in path.read_text().splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        if line.startswith("other"):
            other = int(line.split()[1])
        else:
            rows.append([int(v) for v in line.split()])
    core = np.array(rows, np.int32)
    if core.shape != (20, 20) or not np.array_equal(core, core.T) or other is None:
        raise ValueError(f"{path.name}: not a symmetric 20 x 20 core and an 'other' line")
    m = np.full((21, 21), other, np.int32)
    m[:20, :20] = core
    return m
