"""The port's multi-query batch path on the CPU against the JAX package.

The plain versions of the batch kernels (cell batch B4, col flat B5, col
fused B6) against the JAX package's Pallas kernels in interpret mode; the
flat-pool planner and the pass dispatch against the JAX package's; the
wrappers' contract checks; and the engine's ``scan_batch`` and batching
``scan_many`` against the JAX engine and the port's own single scans.
Inputs are made with numpy from seeds.  Tolerance: exact (integer scores
as f32, ids and order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudasw4_tpu.db.packing as jp
from cudasw4_tpu import make_scoring_config as jax_scoring
from cudasw4_tpu.db.format import DBData as JaxDBData
from cudasw4_tpu.engine import SearchEngine as JaxEngine
from cudasw4_tpu.ops import col_flat_plan as jax_col_flat_plan
from cudasw4_tpu.ops import sw_pallas_col
from cudasw4_tpu.ops.sw_pallas_cell import score_bucket_pallas_cell_batch
import cudasw4_tpu_torch.db.packing as tp
from cudasw4_tpu_torch import make_scoring_config
from cudasw4_tpu_torch.db.format import DBData
from cudasw4_tpu_torch.engine import SearchEngine
from cudasw4_tpu_torch.ops import batch_col_scores, col_flat_plan, sw_cell, sw_col

MATS = ["blosum62", "blosum62_full"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers,
    and torch's thread pool spinning against them slows these tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiles(rng, shape, pad, A):
    """Subject codes in [0, A-1) with ragged lengths; pad past each."""
    T, L = shape[0], shape[1]
    x = rng.integers(0, A - 1, size=(T, L, 4096)).astype(np.int8)
    lens = rng.integers(1, L + 1, size=(T, 1, 4096))
    x[np.arange(L)[None, :, None] >= lens] = pad
    return np.ascontiguousarray(x.reshape(shape))


def _slots(rng, lengths, W, pad, A):
    q = np.full((len(lengths), W), pad, np.int32)
    for s, n in enumerate(lengths):
        q[s, :n] = rng.integers(0, A - 1, size=n)
    return q


def _params(cfg, rows):
    return np.array([0, cfg.gop, cfg.gex, 0, *rows], np.int32)


def _mat(cfg):
    return cfg.matrix.astype(np.int32).reshape(-1)


# ------------------------------------------------------------- kernels


@pytest.mark.parametrize("mat", MATS)
def test_cell_batch_plain_equals_pallas(mat):
    """QB = 4 slots, one of them empty (nq = 0, scores 0)."""
    rng = np.random.default_rng(31)
    cfg = jax_scoring(mat)
    A, pad = cfg.alphabet_size, cfg.pad_code
    tiles = _tiles(rng, (1, 32, 32, 128), pad, A)
    nqs = [13, 0, 40, 7]
    q = _slots(rng, nqs, 64, pad, A)
    params = _params(cfg, nqs)
    want = score_bucket_pallas_cell_batch(
        jnp.asarray(tiles), jnp.asarray(q), jnp.asarray(_mat(cfg)), jnp.asarray(params),
        interpret=True, unroll=8, exact=True,
    )
    got = sw_cell.score_bucket_cell_batch(
        torch.as_tensor(tiles), torch.as_tensor(q), torch.as_tensor(_mat(cfg)), params
    )
    assert got.shape == (4, 1, 4096)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert not got[1].any()


@pytest.fixture
def col_geometry(monkeypatch):
    monkeypatch.setattr(sw_pallas_col, "LC", 16)
    monkeypatch.setattr(sw_col, "LC", 16)


# (row counts, pool offsets, query block width): mixed lengths, and the
# pool of 128 rows full.
FLAT_CASES = {
    "mixed": ((8, 24, 16, 24), (0, 32, 64, 96), 24),
    "pool_full": ((48, 48, 32), (0, 48, 96), 48),
}


@pytest.mark.parametrize("mat,case", [(m, "mixed") for m in MATS] + [("blosum62", "pool_full")])
def test_col_flat_and_fused_plain_equal_pallas(col_geometry, mat, case):
    """B5 and B6 (plain) against their Pallas kernels at LC = 16, rtot =
    128, on the same slots; real lengths below the padded row counts, so
    pad rows are walked."""
    rng = np.random.default_rng(32)
    cfg = jax_scoring(mat)
    A, pad = cfg.alphabet_size, cfg.pad_code
    nqps, offs, W = FLAT_CASES[case]
    tiles = _tiles(rng, (1, 32, 32, 128), pad, A)
    q = _slots(rng, [max(1, n - 3) for n in nqps], W, pad, A)
    params = _params(cfg, nqps)
    jargs = (jnp.asarray(tiles), jnp.asarray(q), jnp.asarray(_mat(cfg)), jnp.asarray(params))
    targs = (torch.as_tensor(tiles), torch.as_tensor(q), torch.as_tensor(_mat(cfg)), params)
    want = np.asarray(sw_pallas_col.score_bucket_pallas_col_flat(
        *jargs, offs=offs, rtot=128, interpret=True, unroll=8, exact=True))
    got = sw_col.score_bucket_col_flat(*targs, offs, rtot=128)
    assert np.array_equal(got.numpy(), want)
    want_f = np.asarray(sw_pallas_col.score_bucket_pallas_col_flat_fused(
        *jargs, rtot=128, interpret=True, unroll=8, exact=True))
    got_f = sw_col.score_bucket_col_flat_fused(*targs, rtot=128)
    assert np.array_equal(got_f.numpy(), want_f)
    assert np.array_equal(want_f, want)


def test_fused_wrapper_device_arguments(monkeypatch):
    """B6's launch arguments on a device tensor (here "meta", so that no
    kernel runs): the slots' gapless starts, whatever the slot sizes (0
    rows, offsets that are no multiple of 32), and a pool of sum(nqp)
    rows, not the contract's rtot."""
    from cudasw4_tpu_torch.ops import cuda_lib

    calls = []

    def fake(wrapper, kernel, tiles, queries, matrix_flat, gop, gex, slots=None, **kw):
        calls.append((wrapper, kernel, gop, gex, slots, kw))
        return torch.zeros((queries.shape[0], tiles.shape[0], 4096)), None

    monkeypatch.setattr(cuda_lib, "launch_col", fake)
    nqps = (16, 0, 8, 40, 24)
    t = torch.empty((1, 1152, 32, 128), dtype=torch.int8, device="meta")
    q = torch.empty((len(nqps), 64), dtype=torch.int32, device="meta")
    m = torch.empty(441, dtype=torch.int32, device="meta")
    got = sw_col.score_bucket_col_flat_fused(t, q, m, (0, -11, -1, 0, *nqps), rtot=3072)
    assert got.shape == (5, 1, 4096)
    assert calls == [(sw_col.score_bucket_col_flat_fused, "sw_col_fused_kernel", -11, -1,
                      (None, [0, 16, 16, 24, 64, 88], 88), {"sat": 0, "lengths": None})]


# ---------------------------------------------------------------- plan

REFERENCE_PADS = [144, 192, 224, 376, 464, 568, 664, 736, 856, 1000, 1504, 2008, 2504, 3008]


@pytest.mark.parametrize("seed", [None, 0, 1, 2, 3])
def test_col_flat_plan_equals_jax(seed):
    """The 14 padded row counts of the reference query set's batch (seed
    None), then random pads, with and without ``limit``."""
    if seed is None:
        pads = REFERENCE_PADS
        plan = col_flat_plan(pads, rtot=3072)
        assert sorted(len(p) for p in plan) == [1, 2, 2, 3, 6]
        assert ((7, 0), (6, 768), (3, 1536), (2, 1920), (1, 2176), (0, 2432)) in plan
    else:
        rng = np.random.default_rng(seed)
        pads = (rng.integers(1, 385, size=16) * 8).tolist()
    for limit in (None, 3, 9):
        for rtot in (3072, 1024 + 8 * (seed or 0)):
            kw = dict(limit=limit, rtot=rtot)
            try:
                want = jax_col_flat_plan(pads, **kw)
            except ValueError as ex:
                with pytest.raises(ValueError) as got:
                    col_flat_plan(pads, **kw)
                assert str(got.value) == str(ex)
                continue
            assert col_flat_plan(pads, **kw) == want


def test_col_flat_plan_rejects_slot_longer_than_pool():
    for fn in (col_flat_plan, jax_col_flat_plan):
        with pytest.raises(ValueError):
            fn([4000], rtot=3072)


@pytest.mark.parametrize("fuse_min", [0, 3])
def test_batch_col_scores_dispatch(col_geometry, monkeypatch, fuse_min):
    """Passes of 1, 2, 3 and 4 slots: with COL_FUSE_MIN_S = 3 exactly the
    last two run on the fused kernel; with 0, none.  Every slot's scores
    equal its plain sweep."""
    monkeypatch.setattr(sw_col, "COL_FUSE_MIN_S", fuse_min)
    rng = np.random.default_rng(33)
    cfg = make_scoring_config("blosum62")
    tiles = torch.as_tensor(_tiles(rng, (1, 16, 32, 128), cfg.pad_code, 21))
    lengths = [9, 16, 3, 5, 8, 12, 1, 4, 7, 2]
    pads = [max(8, -(-n // 8) * 8) for n in lengths]
    QB = len(lengths)
    q = torch.as_tensor(_slots(rng, lengths, 16, cfg.pad_code, 21))
    params = np.array([0, cfg.gop, cfg.gex, 0, *lengths, *pads], np.int32)
    plan = (((0, 0),), ((1, 0), (2, 16)), ((3, 0), (4, 8), (5, 16)),
            ((6, 0), (7, 8), (8, 16), (9, 24)))
    m = torch.as_tensor(_mat(cfg))
    flat0 = sw_col.score_bucket_col_flat.plain_calls
    fused0 = sw_col.score_bucket_col_flat_fused.plain_calls
    got = {}
    for scores, slots in batch_col_scores(tiles, q, m, params, QB, plan, rtot=32):
        for i, slot in enumerate(slots):
            got[slot] = scores[i]
    n_fused = 2 if fuse_min else 0
    assert sw_col.score_bucket_col_flat_fused.plain_calls - fused0 == n_fused
    assert sw_col.score_bucket_col_flat.plain_calls - flat0 == 4 - n_fused
    want = sw_col.score_bucket_col_flat_plain(tiles, q, m, [*params[:4].tolist(), *pads])
    assert sorted(got) == list(range(QB))
    for slot in range(QB):
        assert torch.equal(got[slot], want[slot])


def test_batch_col_scores_tile_groups(col_geometry, monkeypatch):
    """With TEMP_BYTES at one tile's boundary columns, every pass launches
    once a tile, and the scores equal the plain sweep of all tiles."""
    from cudasw4_tpu_torch.ops import cuda_lib

    rng = np.random.default_rng(34)
    cfg = make_scoring_config("blosum62")
    tiles = torch.as_tensor(_tiles(rng, (3, 32, 32, 128), cfg.pad_code, 21))
    lengths = [9, 16, 3]
    pads = [max(8, -(-n // 8) * 8) for n in lengths]
    q = torch.as_tensor(_slots(rng, lengths, 16, cfg.pad_code, 21))
    params = np.array([0, cfg.gop, cfg.gex, 0, *lengths, *pads], np.int32)
    plan = (((0, 0), (1, 16)), ((2, 0),))
    monkeypatch.setattr(cuda_lib, "TEMP_BYTES", cuda_lib.col_boundary_bytes(1, 32))
    m = torch.as_tensor(_mat(cfg))
    flat0 = sw_col.score_bucket_col_flat.plain_calls
    got = {}
    for scores, slots in batch_col_scores(tiles, q, m, params, 3, plan, rtot=32):
        assert scores.shape[1] == 3
        for i, slot in enumerate(slots):
            got[slot] = scores[i]
    assert sw_col.score_bucket_col_flat.plain_calls - flat0 == 2 * 3
    want = sw_col.score_bucket_col_flat_plain(tiles, q, m, [*params[:4].tolist(), *pads])
    for slot in range(3):
        assert torch.equal(got[slot], want[slot])


@pytest.mark.parametrize("fuse_min", [0, 2])
def test_batch_col_scores_pass_each_groups_lengths(monkeypatch, fuse_min):
    """B5 (and B6 where COL_FUSE_MIN_S sends a pass there) on the card's
    branch ("meta" tiles, ``launch_col`` patched): in one-tile groups each
    launch takes the lengths of exactly its tile, and counts S x its warps'
    own passes (``col_warp_passes``) beside S x 4096 x ceil(L / COL_PASS)
    (``col_bucket_passes``)."""
    from cudasw4_tpu_torch.ops import cuda_lib

    monkeypatch.setattr(sw_col, "COL_FUSE_MIN_S", fuse_min)
    calls = []

    def fake(wrapper, kernel, tiles, queries, matrix_flat, gop, gex, slots=None, **kw):
        calls.append((wrapper, queries.shape[0], kw["lengths"]))
        return torch.zeros((queries.shape[0], tiles.shape[0], 4096)), None

    monkeypatch.setattr(cuda_lib, "launch_col", fake)
    monkeypatch.setattr(cuda_lib, "to_device", lambda a, dev: torch.as_tensor(a).to(dev))
    rng = np.random.default_rng(35)
    L = 1152
    lens = rng.integers(0, L + 1, size=(3, 4096)).astype(np.int32)
    cl = sw_col.ColLengths.place(lens, "cpu")
    t = torch.empty((3, L, 32, 128), dtype=torch.int8, device="meta")
    q = torch.empty((3, 16), dtype=torch.int32, device="meta")
    m = torch.empty(441, dtype=torch.int32, device="meta")
    params = np.array([0, -11, -1, 0, 9, 16, 3, 16, 16, 8], np.int32)
    plan = (((0, 0), (1, 16)), ((2, 0),))
    wrappers = (sw_col.score_bucket_col_flat, sw_col.score_bucket_col_flat_fused)
    before = [sum(getattr(w, n) for w in wrappers) for n in ("col_warp_passes", "col_bucket_passes")]
    for scores, slots in batch_col_scores(t, q, m, params, 3, plan, rtot=32, lengths=cl,
                                          temp_bytes=cuda_lib.col_boundary_bytes(1, 32)):
        assert scores.shape == (len(slots), 3, 4096)
    want = [(sw_col.score_bucket_col_flat_fused if fuse_min and S >= 2
             else sw_col.score_bucket_col_flat, S) for S in (2, 1) for _ in range(3)]
    assert [(w, S) for w, S, _ in calls] == want
    for k, (_, _, got) in enumerate(calls):
        assert torch.equal(got, torch.as_tensor(lens[k % 3 : k % 3 + 1]))
    per_tile = (-(-lens.astype(np.int64) // sw_col.COL_PASS)).sum(axis=1)
    after = [sum(getattr(w, n) for w in wrappers) for n in ("col_warp_passes", "col_bucket_passes")]
    assert after == [before[0] + 3 * int(per_tile.sum()),
                     before[1] + 3 * 3 * 4096 * -(-L // sw_col.COL_PASS)]


# ------------------------------------------------------------- contract


def _args(nq=(8, 8), W=16, L=32, g=32):
    tiles = torch.full((1, L, g, 128), 20, dtype=torch.int8)
    q = torch.full((len(nq), W), 20, dtype=torch.int32)
    return tiles, q, torch.zeros(441, dtype=torch.int32), [0, -11, -1, 0, *nq]


BAD_CALLS = {
    "cell: not 32 x 128": lambda: sw_cell.score_bucket_cell_batch(*_args(g=16)),
    "cell: L not a multiple of 8": lambda: sw_cell.score_bucket_cell_batch(*_args(L=36)),
    "cell: nq beyond the block": lambda: sw_cell.score_bucket_cell_batch(*_args(nq=(8, 17))),
    "cell: params too short": lambda: sw_cell.score_bucket_cell_batch(*_args()[:3], [0, -11, -1, 0, 8]),
    "flat: not 32 x 128": lambda: sw_col.score_bucket_col_flat(*_args(g=16), (0, 8), rtot=64),
    "flat: L % LC": lambda: sw_col.score_bucket_col_flat(*_args(L=40), (0, 8), rtot=64),
    "flat: W > rtot": lambda: sw_col.score_bucket_col_flat(*_args(W=72), (0, 8), rtot=64),
    "flat: len(offs) != S": lambda: sw_col.score_bucket_col_flat(*_args(), (0,), rtot=64),
    "flat: max(offs) >= rtot": lambda: sw_col.score_bucket_col_flat(*_args(), (0, 64), rtot=64),
    "flat: rows pass rtot": lambda: sw_col.score_bucket_col_flat(*_args(), (0, 60), rtot=64),
    "flat: rows overlap": lambda: sw_col.score_bucket_col_flat(*_args(), (0, 4), rtot=64),
    "flat: nqp not a multiple of 8": lambda: sw_col.score_bucket_col_flat(*_args(nq=(8, 12)), (0, 16), rtot=64),
    "flat: nqp beyond the block": lambda: sw_col.score_bucket_col_flat(*_args(nq=(8, 24)), (0, 16), rtot=64),
    "fused: L % LC": lambda: sw_col.score_bucket_col_flat_fused(*_args(L=40), rtot=64),
    "fused: W > rtot": lambda: sw_col.score_bucket_col_flat_fused(*_args(W=72), rtot=64),
    "fused: rtot % unroll": lambda: sw_col.score_bucket_col_flat_fused(*_args(), rtot=60),
    "fused: sum(nqp) > rtot": lambda: sw_col.score_bucket_col_flat_fused(*_args(nq=(16, 16)), rtot=24),
    "fused: nqp not a multiple of 8": lambda: sw_col.score_bucket_col_flat_fused(*_args(nq=(8, 3)), rtot=64),
}


@pytest.mark.parametrize("case", sorted(BAD_CALLS))
def test_batch_wrappers_reject_contract_breaches(col_geometry, case):
    with pytest.raises(ValueError):
        BAD_CALLS[case]()


# --------------------------------------------------------------- engine


def _database(rng):
    """Row, cell and col buckets (with CELL_MAX_L lowered to 48), and four
    copies of one 40-aa sequence for score ties."""
    lengths = np.concatenate([
        rng.integers(5, 33, size=60),
        rng.integers(33, 49, size=2500),
        rng.integers(49, 129, size=1500),
    ])
    seqs = [rng.integers(0, 20, size=int(n)).astype(np.int8) for n in lengths]
    tie = rng.integers(0, 20, size=40).astype(np.int8)
    for k in (100, 900, 2000, 3000):
        seqs[k] = tie
    seqs.sort(key=len)
    lens = np.array([len(s) for s in seqs], np.int32)
    offsets = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum((lens + 3) // 4 * 4, out=offsets[1:])
    chars = np.full(int(offsets[-1]), 20, np.int8)
    for s, a in zip(seqs, offsets[:-1]):
        chars[a : a + len(s)] = s
    names = [b"s%d" % i for i in range(len(seqs))]
    hoff = np.zeros(len(seqs) + 1, np.uint64)
    np.cumsum([len(n) for n in names], out=hoff[1:])
    fields = dict(chars=chars, offsets=offsets.astype(np.uint64), lengths=lens,
                  headers=np.frombuffer(b"".join(names), np.uint8), header_offsets=hoff)
    return DBData(**fields), JaxDBData(**fields), tie


#: With NQC lowered to 24 and QB_MAX to 4: a full group of four, a group
#: of one flushed by a 30-aa single, a group of two flushed by a 40-aa
#: single, and a last group of one.
QUERY_LENGTHS = (10, 20, 24, 5, 17, 30, 8, 12, 40, 3)


def _lower(mp):
    mp.setattr(jp, "CELL_MAX_L", 48)
    mp.setattr(tp, "CELL_MAX_L", 48)
    mp.setattr(sw_col, "NQC", 24)


@pytest.fixture(scope="module")
def setup():
    """The database, the queries (the second is a 20-aa piece of the tie
    sequence) and the JAX engine's results, computed once."""
    rng = np.random.default_rng(34)
    db, jdb, tie = _database(rng)
    queries = [rng.integers(0, 20, size=n).astype(np.int8) for n in QUERY_LENGTHS]
    queries[1] = tie[10:30].copy()
    with pytest.MonkeyPatch.context() as mp:
        _lower(mp)
        jeng = JaxEngine(scoring=jax_scoring("blosum62"), num_top=6, qcap=40)
        jeng.set_database(jdb)
        want = [(r.scores, r.reference_ids) for r in map(jeng.scan, queries)]
    return db, queries, want


@pytest.fixture
def engine(setup, monkeypatch):
    _lower(monkeypatch)
    eng = SearchEngine(scoring=make_scoring_config("blosum62"), num_top=6, device="cpu")
    eng.QB_MAX = 4
    eng.set_database(setup[0])
    assert [b.kernel for b in eng.packed.buckets] == ["row", "cell", "col"]
    assert eng._qcap_batch == 24 and eng._qb_cap == 4
    return eng


def _results(rs):
    return [(r.scores, r.reference_ids) for r in rs]


def test_engine_scan_many_batches_equal_jax_and_singles(setup, engine):
    _, queries, want = setup
    cell0 = sw_cell.score_bucket_cell_batch.plain_calls
    single0 = sw_cell.score_bucket_cell.plain_calls
    got = _results(engine.scan_many(queries))
    assert got == want
    # four batches (one cell batch call each) and two singles
    assert sw_cell.score_bucket_cell_batch.plain_calls - cell0 == 4
    assert sw_cell.score_bucket_cell.plain_calls - single0 == 2
    assert _results(engine.scan(q) for q in queries) == want
    scores, ids = want[1]
    assert scores[0] == scores[3] and ids[:4] == sorted(ids[:4])


def test_engine_scan_batch_equals_jax_and_splits_seconds(setup, engine):
    _, queries, want = setup
    short = [k for k, n in enumerate(QUERY_LENGTHS) if n <= 24][:4]
    res = engine.scan_batch([queries[k] for k in short])
    assert _results(res) == [want[k] for k in short]
    lengths = [QUERY_LENGTHS[k] for k in short]
    ratios = [r.stats.seconds / n for r, n in zip(res, lengths)]
    assert ratios == pytest.approx([ratios[0]] * 4)
    assert all(r.stats.gcups > 0 for r in res)


def test_engine_scan_batch_rejects(setup, engine):
    _, queries, _ = setup
    with pytest.raises(ValueError):
        engine.scan_batch(queries[:5])  # more than QB_MAX
    with pytest.raises(ValueError):
        engine.scan_batch([queries[5]])  # 30 aa > _qcap_batch
    assert engine.scan_batch([]) == []
    with pytest.raises(RuntimeError):
        SearchEngine(device="cpu").scan_batch(queries[:1])


def test_engine_batch_debug_check_rescores_every_slot(setup, engine, monkeypatch):
    _, queries, _ = setup
    monkeypatch.setattr(engine, "debug_check", True)
    checked = []
    monkeypatch.setattr(engine, "_debug_check_result", lambda c, r: checked.append(len(c)))
    engine.scan_batch(queries[:3])
    assert checked == [10, 20, 24]


def test_engine_batch_without_col_buckets_and_empty_db(setup):
    """Without col buckets a batch takes queries up to QCAP_BATCH; an
    empty database gives empty results."""
    db, queries, _ = setup
    eng = SearchEngine(num_top=3, device="cpu")
    eng.set_database(db)
    assert "col" not in [b.kernel for b in eng.packed.buckets]
    assert eng._qcap_batch == sw_cell.QCAP_BATCH
    got = _results(eng.scan_batch(queries[5:9]))
    assert got == _results(eng.scan(q) for q in queries[5:9])
    empty = tp.packed_from_arrays([], 0, 0)
    eng.set_database(db, packed=empty)
    assert _results(eng.scan_batch(queries[:2])) == [([], []), ([], [])]


def test_align_cli_scan_time_lines_through_batches(tmp_path, capsys, monkeypatch):
    """align --verbose on the golden fixtures with QB_MAX lowered to 3:
    the queries run as several batches, each prints its own Scan time
    line with the batch's seconds split by cells, and the TSV still
    equals the golden file byte for byte."""
    import os

    from cudasw4_tpu_torch.cli import align, makedb

    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
    monkeypatch.setattr(SearchEngine, "QB_MAX", 3)
    prefix = str(tmp_path / "gdb")
    assert makedb.run([os.path.join(fix, "golden_db.fa"), prefix]) == 0
    capsys.readouterr()
    tsv = str(tmp_path / "hits.tsv")
    queries = os.path.join(fix, "golden_queries.fa")
    assert align.run(["--query", queries, "--db", prefix, "--top", "10", "--tsv",
                      "--verbose", "--of", tsv, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    with open(queries) as f:
        n = sum(line.startswith(">") for line in f)
    times = [line.split("Scan time: ")[1] for line in out.splitlines() if "Scan time: " in line]
    assert n > 3 and len(times) == n
    assert all(float(t.split(" s, ")[0]) > 0 and float(t.split(" s, ")[1].split()[0]) > 0
               for t in times)
    assert "Total time:" in out
    with open(tsv) as a, open(os.path.join(fix, "golden_top10.tsv")) as b:
        assert a.read() == b.read()
