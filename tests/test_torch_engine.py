"""The port's SearchEngine on the CPU against the JAX package's engine.

One database of ~4k sequences packs into all three bucket kinds (row,
cell and col), with duplicated sequences for score ties; the queries
include one longer than a lowered NQC (24), so the port walks its chunked
col branch with the H/F carry.  To keep the JAX engine's CPU scorer
quick, both packages pack with CELL_MAX_L lowered to 48, so the long tail
(49..128 aa) packs into a col bucket of L=128, and the JAX engine pads
its queries to qcap=40 rows; its results are computed once per module.
Tolerance: exact scores, ids and order.
"""

import numpy as np
import pytest
import torch

import cudasw4_tpu.db.packing as jp
from cudasw4_tpu import make_scoring_config as jax_scoring
from cudasw4_tpu.db.format import DBData as JaxDBData
from cudasw4_tpu.engine import SearchEngine as JaxEngine
import cudasw4_tpu_torch.db.packing as tp
from cudasw4_tpu_torch import make_scoring_config
from cudasw4_tpu_torch.db.format import DBData
from cudasw4_tpu_torch.engine import SearchEngine
from cudasw4_tpu_torch.ops import sw_col


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers,
    and torch's thread pool spinning against them slows these tests about
    tenfold (alone they take the same time either way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _database(rng):
    lengths = np.concatenate([
        rng.integers(5, 33, size=60),       # row bucket, L=32
        rng.integers(33, 49, size=2500),    # cell bucket, L=48
        rng.integers(49, 129, size=1500),   # col bucket, L=128
    ])
    seqs = [rng.integers(0, 20, size=int(n)).astype(np.int8) for n in lengths]
    tie = rng.integers(0, 20, size=40).astype(np.int8)
    for k in (100, 900, 2000, 3000):  # four copies of one sequence: ties
        seqs[k] = tie
    order = np.argsort([len(s) for s in seqs], kind="stable")
    seqs = [seqs[i] for i in order]
    lens = np.array([len(s) for s in seqs], np.int32)
    pads = (lens + 3) // 4 * 4
    offsets = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum(pads, out=offsets[1:])
    chars = np.full(int(offsets[-1]), 20, np.int8)
    for s, a in zip(seqs, offsets[:-1]):
        chars[a : a + len(s)] = s
    hdr = np.frombuffer(b"".join(b"s%d" % i for i in range(len(seqs))), np.uint8)
    hoff = np.zeros(len(seqs) + 1, np.uint64)
    np.cumsum([len(b"s%d" % i) for i in range(len(seqs))], out=hoff[1:])
    fields = dict(chars=chars, offsets=offsets.astype(np.uint64), lengths=lens,
                  headers=hdr, header_offsets=hoff)
    return DBData(**fields), JaxDBData(**fields), tie


QUERY_LENGTHS = (23, 37)  # with the 40-aa tie query; 37 > the lowered NQC


def _lower(mp):
    mp.setattr(jp, "CELL_MAX_L", 48)
    mp.setattr(tp, "CELL_MAX_L", 48)
    mp.setattr(sw_col, "NQC", 24)


@pytest.fixture(scope="module")
def setup():
    """The database, the queries, and the JAX engine's results and packed
    database per alphabet (computed once: the JAX CPU scorer is slow)."""
    rng = np.random.default_rng(51)
    db, jdb, tie = _database(rng)
    queries = [tie] + [rng.integers(0, 20, size=n).astype(np.int8) for n in QUERY_LENGTHS]
    want = {}
    with pytest.MonkeyPatch.context() as mp:
        _lower(mp)
        for mat in ("blosum62", "blosum62_full"):
            jeng = JaxEngine(scoring=jax_scoring(mat), num_top=12, qcap=40)
            jeng.set_database(jdb)
            want[mat] = (_results(jeng.scan(q) for q in queries), jeng.packed)
    return db, queries, want


@pytest.fixture
def lowered(monkeypatch):
    _lower(monkeypatch)


def _results(rs):
    return [(r.scores, r.reference_ids) for r in rs]


@pytest.mark.parametrize("mat", ["blosum62", "blosum62_full"])
def test_engine_scan_many_equals_jax(setup, lowered, mat):
    db, queries, want = setup
    want = want[mat][0]
    eng = SearchEngine(scoring=make_scoring_config(mat), num_top=12, device="cpu")
    eng.set_database(db)
    assert [b.kernel for b in eng.packed.buckets] == ["row", "cell", "col"]
    assert _results(eng.scan_many(queries)) == want
    assert _results([eng.scan(queries[0])]) == want[:1]
    # the tie query's copies score equally and come out by ascending id
    scores, ids = want[0]
    assert scores[0] == scores[3] and ids[:4] == sorted(ids[:4])


def test_engine_on_jax_packed_db(setup, lowered):
    """The identical packed database, carried from the JAX package with
    packed_from_arrays, gives the identical results."""
    db, queries, want = setup
    want, jpacked = want["blosum62"]
    packed = tp.packed_from_arrays(
        [dict(L=b.L, NS=b.NS, kernel=b.kernel, tiles=b.tiles, seq_index=b.seq_index,
              lengths=b.lengths) for b in jpacked.buckets],
        jpacked.num_sequences, jpacked.total_real_chars,
    )
    eng = SearchEngine(scoring=make_scoring_config("blosum62"), num_top=12, device="cpu")
    eng.set_database(db, packed=packed)
    assert _results(eng.scan_many(queries, window=0)) == want


def test_engine_stats_and_unported_paths(setup):
    db, queries, _ = setup
    eng = SearchEngine(num_top=3, device="cpu")
    with pytest.raises(RuntimeError):
        eng.scan(queries[0])
    eng.set_database(db)
    eng.total_timer_start()
    r = eng.scan(queries[1])
    total = eng.total_timer_stop()
    assert len(r.scores) == 3 and r.stats.seconds > 0 and total.gcups > 0
    assert eng.results_per_query == 3 and eng.num_sequences() == db.num_sequences
    assert eng.get_reference_length(r.reference_ids[0]) == int(db.lengths[r.reference_ids[0]])
    assert eng.get_reference_header(0) == "s0"
    assert len(eng.get_reference_sequence(5)) == int(db.lengths[5])
    with pytest.raises(NotImplementedError):
        eng.scan(np.zeros(8193, np.int8))
    with pytest.raises(NotImplementedError):
        eng.set_database(db, pack_cache="x.npz")
    with pytest.raises(NotImplementedError):
        SearchEngine(device="cpu", max_device_bytes=1000).set_database(db)


def test_engine_debug_check_and_device_default(setup, monkeypatch):
    db, queries, _ = setup
    monkeypatch.setenv("CUDASW4_TPU_TORCH_DEBUG_CHECK", "1")
    eng = SearchEngine(num_top=4, device="cpu")
    eng.set_database(db)
    eng.scan(queries[1])  # re-scored on the scalar oracle; raises on a mismatch
    eng._debug_check_result(queries[1], eng.scan(queries[1]))
    bad = eng.scan(queries[1])
    bad.scores[0] += 1
    with pytest.raises(AssertionError):
        eng._debug_check_result(queries[1], bad)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError):
        SearchEngine()
