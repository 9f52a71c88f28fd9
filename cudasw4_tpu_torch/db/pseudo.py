"""Deterministic pseudo database (the port's own copy of
cudasw4_tpu/db/pseudo.py).

Byte-compatible re-implementation of the reference's PseudoDBdata
(the reference's src/dbdata.hpp:219-326): ``num`` copies of a single random
sequence of length ``length``, generated with std::mt19937(seed) +
std::uniform_int_distribution<>(0, 19) over the letters "ARNDCQEGHILKMFPSTWYV",
padded to a multiple of 4 chars, headers all "H".

We re-implement MT19937 (the standard init_genrand seeding used by
std::mt19937) and libstdc++'s downscaling uniform_int_distribution so the
generated sequence matches the reference bit-for-bit; validated against a
g++-compiled dump in tests/test_pseudo.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import AMINO_ACIDS, encode, pad_length

_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER_MASK = 0x80000000
_LOWER_MASK = 0x7FFFFFFF


class MT19937:
    """The classic 32-bit Mersenne Twister (matches std::mt19937)."""

    def __init__(self, seed: int = 5489):
        self.mt = np.zeros(_N, dtype=np.uint64)
        self.mti = _N
        self.mt[0] = seed & 0xFFFFFFFF
        for i in range(1, _N):
            prev = int(self.mt[i - 1])
            self.mt[i] = (1812433253 * (prev ^ (prev >> 30)) + i) & 0xFFFFFFFF

    def _generate_block(self) -> None:
        # In-place sequential twist; later entries intentionally observe
        # already-updated earlier entries, exactly like the canonical code.
        mt = self.mt
        for i in range(_N):
            y = (int(mt[i]) & _UPPER_MASK) | (int(mt[(i + 1) % _N]) & _LOWER_MASK)
            mt[i] = int(mt[(i + _M) % _N]) ^ (y >> 1) ^ (_MATRIX_A if (y & 1) else 0)
        self.mti = 0

    def next_u32(self) -> int:
        if self.mti >= _N:
            self._generate_block()
        y = int(self.mt[self.mti])
        self.mti += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60022
        y ^= y >> 18
        return y & 0xFFFFFFFF


def uniform_ints(gen: MT19937, n: int, upper_inclusive: int = 19) -> list[int]:
    """libstdc++ std::uniform_int_distribution<>(0, upper) draw sequence."""
    uerange = upper_inclusive + 1
    scaling = 0xFFFFFFFF // uerange
    out = []
    while len(out) < n:
        ret = gen.next_u32() // scaling
        if ret < uerange:
            out.append(ret)
    return out


@dataclass
class PseudoDB:
    """In-memory database equivalent to the reference pseudo DB."""

    num: int
    length: int
    chars: np.ndarray  # [num * padded_len] int8, encoded 0..20
    offsets: np.ndarray  # [num+1] int64
    lengths: np.ndarray  # [num] int32
    headers: list[bytes]

    @property
    def num_sequences(self) -> int:
        return self.num

    @property
    def total_length(self) -> int:
        return int(self.lengths.sum())


def make_pseudo_db(num: int, length: int, seed: int = 42) -> PseudoDB:
    gen = MT19937(seed)
    codes = uniform_ints(gen, length)
    seq = "".join(AMINO_ACIDS[c] for c in codes)
    padded_len = pad_length(length)
    one = np.full(padded_len, 32, dtype=np.uint8)  # pad with ' ' -> encodes to 20
    one[:length] = np.frombuffer(seq.encode(), dtype=np.uint8)
    encoded = encode(one)
    chars = np.tile(encoded, num)
    offsets = np.arange(num + 1, dtype=np.int64) * padded_len
    lengths = np.full(num, length, dtype=np.int32)
    headers = [b"H"] * num
    return PseudoDB(
        num=num, length=length, chars=chars, offsets=offsets, lengths=lengths, headers=headers
    )
