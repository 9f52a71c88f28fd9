"""Alphabet handling (the port's own copy of cudasw4_tpu/constants.py).

The engine works on a 21-letter alphabet: the 20 standard amino acids in
NCBI order plus a catch-all "other" letter (index 20).  This mirrors the
reference implementation's alphabet encoder (CUDASW++ 4.0,
src/convert.cuh:6-64): known letters map to 0..19, everything else
(including padding) maps to 20, and the inverse maps 20+ to '-'.
"""

from __future__ import annotations

import numpy as np

# NCBI amino-acid ordering.
AMINO_ACIDS = "ARNDCQEGHILKMFPSTWYV"

#: Index used for unknown residues and padding.
UNKNOWN = 20

#: Number of letters in the encoded alphabet (20 amino acids + "other").
ALPHABET_SIZE = 21

#: Pad sequences to a multiple of this many characters (the on-disk DB
#: format of the reference pads every sequence to a multiple of 4;
#: src/makedb.cpp:107-133).
CHAR_PAD = 4


def _build_encode_table() -> np.ndarray:
    table = np.full(256, UNKNOWN, dtype=np.int8)
    for i, aa in enumerate(AMINO_ACIDS):
        # Only upper-case letters map; lower-case falls through to
        # "other", as in the reference, for bit-exact score parity.
        table[ord(aa)] = i
    return table


def _build_decode_table() -> np.ndarray:
    table = np.full(256, ord("-"), dtype=np.uint8)
    for i, aa in enumerate(AMINO_ACIDS):
        table[i] = ord(aa)
    return table


ENCODE_TABLE = _build_encode_table()
DECODE_TABLE = _build_decode_table()


def encode(sequence: str | bytes | np.ndarray) -> np.ndarray:
    """Encode an amino-acid string to int8 codes in [0, 20]."""
    if isinstance(sequence, str):
        raw = np.frombuffer(sequence.encode("latin-1"), dtype=np.uint8)
    elif isinstance(sequence, (bytes, bytearray, memoryview)):
        raw = np.frombuffer(bytes(sequence), dtype=np.uint8)
    else:
        raw = np.asarray(sequence, dtype=np.uint8)
    return ENCODE_TABLE[raw]


def decode(codes: np.ndarray) -> str:
    """Decode int codes back to an amino-acid string ('-' for unknown)."""
    codes = np.asarray(codes)
    return DECODE_TABLE[codes.astype(np.uint8)].tobytes().decode("latin-1")


def pad_length(length: int, multiple: int = CHAR_PAD) -> int:
    """Round ``length`` up to a multiple of ``multiple``."""
    return ((length + multiple - 1) // multiple) * multiple
