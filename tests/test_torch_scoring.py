"""The port's alphabet, scoring tables and oracles against the JAX package's.

Tolerance: exact — tables are integer arrays and scores integers.
"""

import numpy as np
import pytest

import cudasw4_tpu.constants as jc
import cudasw4_tpu.substitution as js
import cudasw4_tpu_torch.constants as tc
import cudasw4_tpu_torch.substitution as ts
from cudasw4_tpu.ops import oracle as jo
from cudasw4_tpu_torch.ops import oracle as to

NAMES = ["blosum45", "blosum50", "blosum62", "blosum80"]


def test_alphabet_tables_equal():
    assert tc.AMINO_ACIDS == jc.AMINO_ACIDS
    assert (tc.UNKNOWN, tc.ALPHABET_SIZE, tc.CHAR_PAD) == (jc.UNKNOWN, jc.ALPHABET_SIZE, jc.CHAR_PAD)
    assert np.array_equal(tc.ENCODE_TABLE, jc.ENCODE_TABLE)
    assert np.array_equal(tc.DECODE_TABLE, jc.DECODE_TABLE)
    raw = bytes(range(256))
    assert np.array_equal(tc.encode(raw), jc.encode(raw))
    assert tc.decode(np.arange(26)) == jc.decode(np.arange(26))
    assert [tc.pad_length(n) for n in range(10)] == [jc.pad_length(n) for n in range(10)]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("suffix", ["", "_20", "_full"])
def test_scoring_configs_equal(name, suffix):
    t = ts.make_scoring_config(name + suffix)
    j = js.make_scoring_config(name + suffix)
    assert (t.gop, t.gex, t.pad_code, t.alphabet_size, t.is_full) == (
        j.gop, j.gex, j.pad_code, j.alphabet_size, j.is_full
    )
    assert t.matrix.dtype == j.matrix.dtype
    assert np.array_equal(t.matrix, j.matrix)
    assert np.array_equal(t.full_matrix, j.full_matrix)
    assert t.matrix.shape[0] in (21, 26)


def test_matrix_dicts_and_gap_checks_equal():
    for a, b in ((ts.MATRICES_20, js.MATRICES_20), (ts.MATRICES_FULL, js.MATRICES_FULL),
                 (ts.MATRICES_FULL26, js.MATRICES_FULL26)):
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[k], b[k]) for k in a)
    assert ts.make_scoring_config("blosum62", gop=-7, gex=-2).gop == -7
    for kwargs in ({"gop": 1}, {"gop": -2, "gex": -3}):
        with pytest.raises(ValueError):
            ts.make_scoring_config("blosum62", **kwargs)
        with pytest.raises(ValueError):
            js.make_scoring_config("blosum62", **kwargs)


@pytest.mark.parametrize("mat", ["blosum62", "blosum45_full", "blosum80"])
def test_oracles_agree_on_random_pairs(mat):
    rng = np.random.default_rng(31)
    cfg = ts.make_scoring_config(mat)
    hi = 25 if cfg.is_full else 21
    q = rng.integers(0, hi, size=37)
    subs = rng.integers(0, hi, size=(6, 29))
    for s in subs:
        a = to.sw_score_scalar(q, s, cfg.matrix, cfg.gop, cfg.gex)
        b = jo.sw_score_scalar(q, s, cfg.matrix, cfg.gop, cfg.gex)
        assert a == b
    assert np.array_equal(
        to.sw_score_rowvec(q, subs, cfg.matrix, cfg.gop, cfg.gex),
        jo.sw_score_rowvec(q, subs, cfg.matrix, cfg.gop, cfg.gex),
    )
    assert list(to.sw_score_rowvec(q, subs, cfg.matrix, cfg.gop, cfg.gex)) == [
        to.sw_score_scalar(q, s, cfg.matrix, cfg.gop, cfg.gex) for s in subs
    ]
