"""The port's int16-state path on the CPU against the JAX package.

The plain versions of the cell and col kernels in int16 mode against the
Pallas kernels with ``exact=False`` in interpret mode, under the SAT rule
(``sw_cell.sat_match``): where the reference scores >= SAT the port must
too, elsewhere the scores are equal.  SAT runs lowered to 30 in both
packages (as tests/test_overflow.py lowers the JAX one) and at the
default (JAX keeps traced Pallas kernels past ``_clear_cache``, keyed by
their shapes, so each SAT runs at its own subject length).  Then the engine with ``state16`` against the JAX engine on
test_overflow.py's two-tile database (exact re-score of the one
saturated tile), the full debug check, ``scan_many``'s singles under
``state16``, and ``align --dpx`` on the golden fixtures.  Inputs are made
with numpy from seeds.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudasw4_tpu.db.packing as jp
from cudasw4_tpu import make_scoring_config as jax_scoring
from cudasw4_tpu import ops as jax_ops
from cudasw4_tpu.db.format import DBData as JaxDBData
from cudasw4_tpu.engine import SearchEngine as JaxEngine
from cudasw4_tpu.ops import sw_pallas_cell, sw_pallas_col
import cudasw4_tpu_torch.db.packing as tp
from cudasw4_tpu_torch import make_scoring_config
from cudasw4_tpu_torch.cli import align, makedb
from cudasw4_tpu_torch.constants import encode
from cudasw4_tpu_torch.db.format import DBData
from cudasw4_tpu_torch.engine import SearchEngine
from cudasw4_tpu_torch.ops import sw_cell, sw_col

MATS = ["blosum62", "blosum62_full"]
SATS = [30, 32000]
FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lower_sat(mp, sat):
    mp.setattr(sw_pallas_cell, "SAT", sat)
    mp.setattr(sw_cell, "SAT", sat)
    sw_pallas_cell.score_bucket_pallas_cell._clear_cache()
    sw_pallas_col.score_bucket_pallas_col._clear_cache()


@pytest.fixture
def sat(request, monkeypatch):
    _lower_sat(monkeypatch, request.param)
    yield request.param
    sw_pallas_cell.score_bucket_pallas_cell._clear_cache()
    sw_pallas_col.score_bucket_pallas_col._clear_cache()


def _tiles(rng, shape, pad, A):
    """Subject codes in [0, A-1) with ragged lengths; pad past each."""
    T, L = shape[0], shape[1]
    x = rng.integers(0, A - 1, size=(T, L, 4096)).astype(np.int8)
    lens = rng.integers(1, L + 1, size=(T, 1, 4096))
    x[np.arange(L)[None, :, None] >= lens] = pad
    return x


def _query_over(x, rng, n, A):
    """A query of ``n`` codes whose first 24 match subject 5's start."""
    q = rng.integers(0, A - 1, size=n).astype(np.int32)
    q[:24] = x[0, :24, 5]
    return q


# ------------------------------------------------------------- kernels


@pytest.mark.parametrize("sat", SATS, indirect=True)
@pytest.mark.parametrize("mat", MATS)
def test_cell16_plain_meets_sat_rule_against_pallas(sat, mat):
    rng = np.random.default_rng(61)
    cfg = jax_scoring(mat)
    A, pad = cfg.alphabet_size, cfg.pad_code
    L = 32 if sat == 30 else 40
    x = _tiles(rng, (1, L, 32, 128), pad, A)
    x[0, :, 5] = rng.integers(0, A - 1, size=L)
    qc = _query_over(x, rng, 30, A)
    qpad = np.full(64, pad, np.int32)
    qpad[:30] = qc
    params = np.array([30, cfg.gop, cfg.gex, 32], np.int32)
    mat_flat = cfg.matrix.astype(np.int32).reshape(-1)
    tiles = x.reshape(1, L, 32, 128)
    want = torch.as_tensor(np.asarray(sw_pallas_cell.score_bucket_pallas_cell(
        jnp.asarray(tiles), jnp.asarray(qpad), jnp.asarray(mat_flat), jnp.asarray(params),
        interpret=True, exact=False)))
    exact = torch.as_tensor(np.asarray(sw_pallas_cell.score_bucket_pallas_cell(
        jnp.asarray(tiles), jnp.asarray(qpad), jnp.asarray(mat_flat), jnp.asarray(params),
        interpret=True, exact=True)))
    before = sw_cell.score_bucket_cell.plain_calls16
    got = sw_cell.score_bucket_cell(torch.as_tensor(tiles), torch.as_tensor(qpad),
                                    torch.as_tensor(mat_flat), params, exact=False)
    assert sw_cell.score_bucket_cell.plain_calls16 == before + 1
    assert bool(sw_cell.sat_match(got, want).all())
    assert bool(sw_cell.sat_match(got, exact).all())
    if sat == 30:
        assert int((exact >= 30).sum()) >= 1 and float(got[0, 5]) >= 30
    else:
        assert torch.equal(got, exact)


@pytest.mark.parametrize("sat", SATS, indirect=True)
@pytest.mark.parametrize("mat", MATS)
def test_col16_plain_meets_sat_rule_against_pallas(sat, mat, monkeypatch):
    """Three query chunks (NQC lowered to 16, LC to 16) with the carry."""
    for mod in (sw_pallas_col, sw_col):
        monkeypatch.setattr(mod, "LC", 16)
        monkeypatch.setattr(mod, "NQC", 16)
    rng = np.random.default_rng(62)
    cfg = jax_scoring(mat)
    A, pad = cfg.alphabet_size, cfg.pad_code
    L = 32 if sat == 30 else 48
    x = _tiles(rng, (1, L, 32, 128), pad, A)
    x[0, :, 5] = rng.integers(0, A - 1, size=L)
    codes = _query_over(x, rng, 40, A).astype(np.int8)
    tiles = x.reshape(1, L, 32, 128)
    mat_flat = cfg.matrix.astype(np.int32).reshape(-1)
    want = torch.as_tensor(np.asarray(sw_pallas_col.score_bucket_col_any_query(
        jnp.asarray(tiles), codes, jnp.asarray(mat_flat), cfg.gop, cfg.gex,
        interpret=True, exact=False, pad=pad)))
    exact = sw_col.score_bucket_col_any_query(
        torch.as_tensor(tiles), codes, torch.as_tensor(mat_flat), cfg.gop, cfg.gex, pad=pad)
    before = sw_col.score_bucket_col.plain_calls16
    got = sw_col.score_bucket_col_any_query(
        torch.as_tensor(tiles), codes, torch.as_tensor(mat_flat), cfg.gop, cfg.gex,
        pad=pad, exact=False)
    assert sw_col.score_bucket_col.plain_calls16 == before + 3
    assert bool(sw_cell.sat_match(got, want).all())
    assert bool(sw_cell.sat_match(got, exact).all())
    if sat == 30:
        assert float(got[0, 5]) >= 30 and int((exact >= 30).sum()) >= 1
    else:
        assert torch.equal(got, exact)


def test_sat_rule_and_sat_bounds():
    want = torch.tensor([5.0, 30.0, 31.0, 29.0])
    assert sw_cell.sat_match(torch.tensor([5.0, 30.0, 40.0, 29.0]), want, 30).all()
    assert not sw_cell.sat_match(torch.tensor([5.0, 29.0, 40.0, 29.0]), want, 30).all()
    assert not sw_cell.sat_match(torch.tensor([6.0, 30.0, 40.0, 29.0]), want, 30).all()
    for bad in (0, 32768):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sw_cell, "SAT", bad)
            with pytest.raises(ValueError):
                sw_cell.score_bucket_cell(torch.zeros((1, 8, 32, 128), dtype=torch.int8),
                                          torch.zeros(8, dtype=torch.int32),
                                          torch.zeros(441, dtype=torch.int32), (4, -11, -1, 8),
                                          exact=False)


# -------------------------------------------------------------- engine


def _two_tile_fields():
    """tests/test_overflow.py's database: 4199 all-G subjects (score 0
    against an all-W query) and one all-W subject (24 x 11 = 264): two
    4096-lane cell tiles, one of which saturates at SAT = 30."""
    seqs = [encode("G" * 16) for _ in range(4199)] + [encode("W" * 24)]
    padlens = [-(-len(s) // 4) * 4 for s in seqs]
    chars = np.full(sum(padlens), 20, np.int8)
    offsets = np.zeros(len(seqs) + 1, np.uint64)
    pos = 0
    for i, s in enumerate(seqs):
        chars[pos : pos + len(s)] = s
        offsets[i] = pos
        pos += padlens[i]
    offsets[-1] = pos
    return dict(chars=chars, offsets=offsets, lengths=np.array([len(s) for s in seqs], np.int32),
                headers=np.zeros(0, np.uint8), header_offsets=np.zeros(len(seqs) + 1, np.uint64))


@pytest.fixture
def two_tiles(monkeypatch):
    """SAT = 30 and the cell layout forced in both packages, the JAX
    Pallas kernels in interpret mode, and a spy on the port's cell
    kernel's plain version (the CPU path of the wrapper) recording
    (tiles, exact) per call."""
    _lower_sat(monkeypatch, 30)
    monkeypatch.setattr(jax_ops, "INTERPRET", True)
    monkeypatch.setattr(jp, "CELL_SPEEDUP", 99.0)
    monkeypatch.setattr(tp, "CELL_SPEEDUP", 99.0)
    calls = []
    real = sw_cell.score_bucket_cell_plain

    def spy(tiles, query, matrix_flat, params, exact=True):
        calls.append((int(tiles.shape[0]), exact))
        return real(tiles, query, matrix_flat, params, exact)

    monkeypatch.setattr(sw_cell, "score_bucket_cell_plain", spy)
    yield calls
    sw_pallas_cell.score_bucket_pallas_cell._clear_cache()


def _port_engine(num_top=5):
    eng = SearchEngine(num_top=num_top, device="cpu")
    eng.state16 = True
    eng.set_database(DBData(**_two_tile_fields()))
    assert [(b.kernel, b.num_tiles) for b in eng.packed.buckets] == [("cell", 2)]
    return eng


def test_engine_state16_rescores_one_tile_like_jax(two_tiles):
    calls = two_tiles
    jeng = JaxEngine(num_top=5, qcap=64, backend="pallas")
    jeng.state16 = True
    jeng.set_database(JaxDBData(**_two_tile_fields()))
    eng = _port_engine()
    for query, overflows in (("W" * 24, 1), ("C" * 8, 0)):
        want = jeng.scan(query)
        calls.clear()
        got = eng.scan(query)
        assert (got.scores, got.reference_ids) == (want.scores, want.reference_ids)
        assert got.stats.num_overflows == want.stats.num_overflows == overflows
        assert calls[0] == (2, False)  # the int16 pass over both tiles
        assert [c for c in calls if c[1]] == ([(1, True)] if overflows else [])
    assert got.scores == [0] * 5
    res = eng.scan("W" * 24)
    assert res.scores[0] == 24 * 11 and res.reference_ids[0] == 4199  # exact, not the clamp


def test_engine_state16_at_default_sat_equals_exact(setup_many):
    db, queries = setup_many
    exact = SearchEngine(num_top=7, device="cpu")
    exact.set_database(db)
    fast = SearchEngine(num_top=7, device="cpu")
    fast.state16 = True
    fast.set_database(db)
    for q in queries:
        a, b = exact.scan(q), fast.scan(q)
        assert (a.scores, a.reference_ids) == (b.scores, b.reference_ids)
        assert b.stats.num_overflows == 0


@pytest.fixture(scope="module")
def setup_many():
    rng = np.random.default_rng(63)
    seqs = [rng.integers(0, 20, size=int(n)).astype(np.int8)
            for n in rng.integers(5, 60, size=300)]
    seqs.sort(key=len)
    lens = np.array([len(s) for s in seqs], np.int32)
    offsets = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum((lens + 3) // 4 * 4, out=offsets[1:])
    chars = np.full(int(offsets[-1]), 20, np.int8)
    for s, a in zip(seqs, offsets[:-1]):
        chars[a : a + len(s)] = s
    db = DBData(chars=chars, offsets=offsets.astype(np.uint64), lengths=lens,
                headers=np.zeros(0, np.uint8), header_offsets=np.zeros(len(seqs) + 1, np.uint64))
    queries = [seqs[10][:30], rng.integers(0, 20, size=17).astype(np.int8), seqs[-1]]
    return db, queries


def test_engine_full_debug_check_under_state16(two_tiles, monkeypatch):
    monkeypatch.setenv("CUDASW4_TPU_TORCH_DEBUG_CHECK", "full")
    eng = _port_engine(num_top=5)
    assert eng.num_top == 4200  # forced to the database size
    res = eng.scan("W" * 24)  # every score diffed against the oracle
    assert len(res.scores) == 4200 and res.stats.num_overflows == 1
    # Without the re-score the clamped int16 scores stand, and the check
    # must catch them.
    monkeypatch.setattr(eng, "_rescore_overflow", lambda t, v, i, c: (v, i))
    with pytest.raises(AssertionError, match="full debug check failed"):
        eng.scan("W" * 24)


def test_engine_scan_many_runs_singles_under_state16(two_tiles):
    eng = _port_engine()
    queries = ["W" * 24, "C" * 8, "W" * 20, "G" * 10]
    before = sw_cell.score_bucket_cell_batch.plain_calls
    got = [(r.scores, r.reference_ids, r.stats.num_overflows) for r in eng.scan_many(queries)]
    assert sw_cell.score_bucket_cell_batch.plain_calls == before  # no batch launch
    want = [(r.scores, r.reference_ids, r.stats.num_overflows) for r in map(eng.scan, queries)]
    assert got == want
    assert [o for _, _, o in got] == [1, 0, 1, 5]  # G x 10 scores 60 on every G subject


@pytest.mark.parametrize("flags", [["--dpx"], ["--singlePassType", "DPXs16"]])
@pytest.mark.parametrize("mat,golden", [
    ("blosum62", "golden_top10.tsv"),
    ("blosum62_full", "golden_top10_full.tsv"),
])
def test_align_dpx_reproduces_golden_tsv(tmp_path, capsys, monkeypatch, mat, golden, flags):
    """At SAT = 30 the golden hits reach SAT, so the TSV rests on the
    overflow re-score and its merge (the golden database packs into row
    buckets, whose kernel is int32 only, as the JAX package's is)."""
    monkeypatch.setattr(sw_cell, "SAT", 30)
    prefix = str(tmp_path / "gdb")
    assert makedb.run([os.path.join(FIXDIR, "golden_db.fa"), prefix]) == 0
    capsys.readouterr()
    assert align.run([
        "--query", os.path.join(FIXDIR, "golden_queries.fa"), "--db", prefix, "--top", "10",
        "--tsv", "--mat", mat, "--device", "cpu", *flags,
    ]) == 0
    out = "".join(line + "\n" for line in capsys.readouterr().out.splitlines()
                  if line and (line[0].isdigit() or line.startswith("Query number")))
    with open(os.path.join(FIXDIR, golden)) as f:
        assert out == f.read()
