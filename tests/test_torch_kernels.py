"""Plain versions of the port's kernels against the JAX package's Pallas
kernels in interpret mode, on the CPU.

Same inputs, made with numpy from a seed, go through each Pallas kernel
(``interpret=True``, explicit ``unroll``, exact int32 state) and through
the port's wrapper on CPU tensors, which takes the kernel's plain version.
Tolerance: exact — the scores and the carried H/F state are integers.
The col kernel runs at the JAX tests' lowered geometry (LC=16, NQC=24,
as tests/test_sw_pallas_col.py does), in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudasw4_tpu import make_scoring_config as jax_scoring
from cudasw4_tpu.ops import sw_pallas_col
from cudasw4_tpu.ops.sw_jax import score_tiles_jnp
from cudasw4_tpu.ops.sw_pallas import prepare_query, score_bucket_pallas
from cudasw4_tpu.ops.sw_pallas_cell import score_bucket_pallas_cell
from cudasw4_tpu_torch import make_scoring_config
from cudasw4_tpu_torch.engine import SearchEngine
from cudasw4_tpu_torch.ops import sw_cell, sw_col, sw_row
from cudasw4_tpu_torch.ops.sw_torch import score_tiles_torch

MATS = ["blosum62", "blosum62_full"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers,
    and torch's thread pool spinning against them slows these tests about
    tenfold (alone they take the same time either way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiles(rng, shape, pad, nreal):
    """Subject codes with ragged lengths, pad past each length and in the
    lanes beyond ``nreal``; codes cover the full 25-letter range so the
    full-blosum rows for B/J/Z/X/* are exercised."""
    T, L = shape[0], shape[1]
    ns = int(np.prod(shape[2:]))
    x = rng.integers(0, 25 if pad == 25 else 20, size=(T, L, ns)).astype(np.int8)
    lens = rng.integers(1, L + 1, size=(T, 1, ns))
    x[np.arange(L)[None, :, None] >= lens] = pad
    flat = x.transpose(0, 2, 1).reshape(T * ns, L)
    flat[nreal:] = pad
    return np.ascontiguousarray(flat.reshape(T, ns, L).transpose(0, 2, 1)).reshape(shape)


def _query(rng, nq, cap, pad):
    q = np.full(cap, pad, np.int32)
    q[:nq] = rng.integers(0, 25 if pad == 25 else 20, size=nq)
    return q


def _mat(cfg):
    return cfg.matrix.astype(np.int32).reshape(-1)


@pytest.mark.parametrize("mat", MATS)
def test_cell_plain_equals_pallas_cell(mat):
    rng = np.random.default_rng(21)
    cfg = jax_scoring(mat)
    pad = cfg.pad_code
    tiles = _tiles(rng, (1, 32, 32, 128), pad, 4096 - 50)
    q = _query(rng, 27, 128, pad)
    params = np.array([27, cfg.gop, cfg.gex, 32], np.int32)
    want = score_bucket_pallas_cell(
        jnp.asarray(tiles), jnp.asarray(q), jnp.asarray(_mat(cfg)), jnp.asarray(params),
        interpret=True, unroll=4, exact=True,
    )
    got = sw_cell.score_bucket_cell(
        torch.as_tensor(tiles), torch.as_tensor(q), torch.as_tensor(_mat(cfg)), params
    )
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_row_plain_equals_pallas_row():
    """Classic alphabet only: the row kernel's interpret-mode trace is the
    slowest here, and both alphabets run through the same plain formula
    (test_sw_torch_equals_sw_jax) and the row kernel on the card."""
    rng = np.random.default_rng(22)
    cfg = jax_scoring("blosum62")
    pad = cfg.pad_code
    tiles = _tiles(rng, (1, 32, 128), pad, 128 - 7)
    codes = rng.integers(0, 25 if pad == 25 else 20, size=30)
    q, nq = sw_row.prepare_query(codes, qcap=128, pad=pad)
    jq, jnq = prepare_query(codes, qcap=128, pad=pad)
    assert np.array_equal(q, jq) and nq == jnq == 30
    params = np.array([30, cfg.gop, cfg.gex, 32], np.int32)
    want = score_bucket_pallas(
        jnp.asarray(tiles), jnp.asarray(q), jnp.asarray(_mat(cfg)), jnp.asarray(params),
        interpret=True,
    )
    got = sw_row.score_bucket_row(
        torch.as_tensor(tiles), torch.as_tensor(q), torch.as_tensor(_mat(cfg)), params
    )
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.fixture
def col_geometry(monkeypatch):
    monkeypatch.setattr(sw_pallas_col, "LC", 16)
    monkeypatch.setattr(sw_pallas_col, "NQC", 24)
    monkeypatch.setattr(sw_col, "LC", 16)
    monkeypatch.setattr(sw_col, "NQC", 24)


def test_col_plain_equals_pallas_col_with_carry(col_geometry):
    """Chunk 1 emits its bottom-row H/F, chunk 2 takes it and emits its
    own, chunk 3 takes it: scores and carried state equal at each step
    (full-blosum alphabet; the cell and row tests cover the classic one)."""
    rng = np.random.default_rng(23)
    cfg = jax_scoring("blosum62_full")
    pad = cfg.pad_code
    tiles = _tiles(rng, (1, 32, 32, 128), pad, 4096)
    m = _mat(cfg)
    jt, tt = jnp.asarray(tiles), torch.as_tensor(tiles)
    jstate = tstate = None
    for k, (nq, emit) in enumerate(((24, True), (24, True), (13, False))):
        q = _query(rng, nq, 24, pad)
        nq_pad = -(-nq // 8) * 8
        params = np.array([nq_pad, cfg.gop, cfg.gex, 0], np.int32)
        want = sw_pallas_col.score_bucket_pallas_col(
            jt, jnp.asarray(q), jnp.asarray(m), jnp.asarray(params),
            state_in=jstate, take_init=jstate is not None, emit_state=emit,
            interpret=True, unroll=8, exact=True,
        )
        got = sw_col.score_bucket_col(
            tt, torch.as_tensor(q), torch.as_tensor(m), params,
            state_in=tstate, take_init=tstate is not None, emit_state=emit,
        )
        if emit:
            (want, jstate), (got, tstate) = want, got
            for a, b in zip(jstate, tstate):
                assert np.array_equal(b.numpy(), np.asarray(a)), f"chunk {k} carry"
        assert np.array_equal(got.numpy(), np.asarray(want)), f"chunk {k} scores"


def test_col_any_query_equals_pallas_any_query(col_geometry):
    """A 41-row query (two NQC=24 chunks) over two tiles in one-tile
    groups, full-blosum alphabet, in both packages' score_bucket_col_any_query
    (the shapes of the test above, so the Pallas traces are reused)."""
    rng = np.random.default_rng(24)
    cfg = jax_scoring("blosum62_full")
    tiles = _tiles(rng, (2, 32, 32, 128), 25, 2 * 4096 - 9)
    codes = rng.integers(0, 25, size=41).astype(np.int8)
    m = _mat(cfg)
    want = sw_pallas_col.score_bucket_col_any_query(
        jnp.asarray(tiles), codes, jnp.asarray(m), cfg.gop, cfg.gex,
        unroll=8, interpret=True, exact=True, pad=25, temp_bytes=1,
    )
    got = sw_col.score_bucket_col_any_query(
        torch.as_tensor(tiles), codes, torch.as_tensor(m), cfg.gop, cfg.gex,
        unroll=8, pad=25, temp_bytes=1,
    )
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("nq", [1, 8, 13, 3072])
@pytest.mark.parametrize("mat", MATS)
def test_query_padding_equals_jax(mat, nq):
    """The port's prepare_query and pad_query_chunk, and the engine's
    single-scan query block and params built on them, against the JAX
    package's padders.  Tolerance: exact."""
    rng = np.random.default_rng(26)
    cfg = jax_scoring(mat)
    codes = rng.integers(0, cfg.alphabet_size - 1, size=nq).astype(np.int8)
    q, n = sw_row.prepare_query(codes, pad=cfg.pad_code)
    jq, jn = prepare_query(codes, pad=cfg.pad_code)
    assert np.array_equal(q, jq) and n == jn == nq
    c, nq_pad = sw_col.pad_query_chunk(codes, pad=cfg.pad_code)
    jc, jnq_pad = sw_pallas_col.pad_query_chunk(codes, pad=cfg.pad_code)
    assert np.array_equal(c, jc) and nq_pad == jnq_pad
    eng = SearchEngine(scoring=make_scoring_config(mat), device="cpu")
    qpad, params = eng._single_qpad(codes)
    assert np.array_equal(qpad, jq)
    assert params.tolist() == [nq, cfg.gop, cfg.gex, jnq_pad]


@pytest.mark.parametrize("mat", MATS)
def test_sw_torch_equals_sw_jax(mat):
    rng = np.random.default_rng(25)
    cfg = jax_scoring(mat)
    pad = cfg.pad_code
    tiles = _tiles(rng, (2, 40, 64), pad, 120)
    q = _query(rng, 33, 64, pad)
    want = score_tiles_jnp(
        jnp.asarray(tiles), jnp.asarray(q), jnp.asarray(cfg.matrix, jnp.float32),
        jnp.float32(cfg.gop), jnp.float32(cfg.gex), jnp.int32(33),
    )
    got = score_tiles_torch(
        torch.as_tensor(tiles), torch.as_tensor(q), torch.as_tensor(cfg.matrix),
        cfg.gop, cfg.gex, 33,
    )
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_plain_path_counts_and_cpu_dispatch():
    """On CPU tensors each wrapper takes its plain version and counts it
    as a plain call, never as a launch."""
    cfg = jax_scoring("blosum62")
    m = torch.as_tensor(_mat(cfg))
    q = torch.full((16,), 20, dtype=torch.int32)
    before = (sw_row.score_bucket_row.launches, sw_row.score_bucket_row.plain_calls)
    sw_row.score_bucket_row(torch.full((1, 8, 128), 20, dtype=torch.int8), q, m, (4, -11, -1, 8))
    assert sw_row.score_bucket_row.launches == before[0]
    assert sw_row.score_bucket_row.plain_calls == before[1] + 1
