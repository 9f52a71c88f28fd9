"""The port's streamed mesh on the CPU: the cases of
tests/test_streaming_mesh.py against the JAX package's streamed mesh, the
port's resident engines and its single device.

A database past the budget streams chunk by chunk on a mesh: each chunk's
tiles split over the shards (the last chunk of a bucket at its real size),
each shard scores its slice and keeps its top N of the chunk, and the
shards' candidates merge at the end of the pass.  The col cases lower
CELL_MAX_L to 48 and NQC to 24 in the port (tests/test_torch_engine.py) and
raise COL_SPEEDUP, so that a row bucket of five tiles and a cell and a col
bucket (L = 128) of one form, and a 30-aa query runs the col carry
(tests/test_torch_sharding.py holds it on several shards at once).
Tolerance: exact scores, ids and order.
"""

import numpy as np
import pytest
import torch

from cudasw4_tpu.db.format import DBData as JaxDBData
from cudasw4_tpu.engine import SearchEngine as JaxEngine
from cudasw4_tpu.parallel import sharding as jsh
import cudasw4_tpu_torch.db.packing as tp
from cudasw4_tpu_torch import engine_streaming as es
from cudasw4_tpu_torch.db.format import DBData
from cudasw4_tpu_torch.engine import SearchEngine
from cudasw4_tpu_torch.ops import sw_cell, sw_col
from cudasw4_tpu_torch.parallel.sharding import make_mesh, shard_ranges


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(rng, lengths, seqs=None):
    """DB fields of random sequences of sorted ``lengths`` (or ``seqs``)."""
    lens = np.sort(np.asarray(lengths)).astype(np.int32)
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum((lens + 3) // 4 * 4, out=offsets[1:])
    chars = np.full(int(offsets[-1]), 20, np.int8)
    for k, (a, n) in enumerate(zip(offsets[:-1], lens)):
        chars[a : a + n] = rng.integers(0, 20, size=int(n)) if seqs is None else seqs[k]
    names = [b"s%d" % i for i in range(len(lens))]
    hoff = np.zeros(len(lens) + 1, np.uint64)
    np.cumsum([len(x) for x in names], out=hoff[1:])
    return dict(chars=chars, offsets=offsets.astype(np.uint64), lengths=lens,
                headers=np.frombuffer(b"".join(names), np.uint8), header_offsets=hoff)


def _results(rs):
    return [(r.scores, r.reference_ids) for r in rs]


def _mesh(n):
    return make_mesh(["cpu"] * n)


def test_streamed_mesh_tie_break_exact():
    """Every score ties (60 copies of one sequence): the streamed mesh
    returns ids 0..6 in order, as the single device's stream and the JAX
    streamed mesh do; a per-shard or per-chunk cut that broke ties by
    anything but the id would show here."""
    rng = np.random.default_rng(5)
    seq = rng.integers(0, 20, size=40).astype(np.int8)
    fields = _fields(rng, [40] * 60, [seq] * 60)
    q = seq[4:30]
    jeng = JaxEngine(num_top=7, qcap=64, mesh=jsh.make_mesh(), max_device_bytes=1,
                     stream_chunk_bytes=1 << 12)
    jeng.set_database(JaxDBData(**fields))
    want = jeng.scan(q)
    assert want.reference_ids == list(range(7))
    single = SearchEngine(num_top=7, device="cpu", max_device_bytes=1, stream_chunk_bytes=1 << 12)
    single.set_database(DBData(**fields))
    eng = SearchEngine(num_top=7, mesh=_mesh(8), max_device_bytes=1, stream_chunk_bytes=1 << 12)
    eng.set_database(DBData(**fields))
    assert eng.streaming
    for e in (single, eng):
        got = e.scan(q)
        assert (got.scores, got.reference_ids) == (want.scores, want.reference_ids)


def test_streamed_mesh_equals_jax_and_resident():
    """A database past each shard's budget streams tile-sharded over 8
    shards: scan and scan_many equal the JAX streamed mesh's and the port's
    resident mesh's."""
    rng = np.random.default_rng(1234)
    fields = _fields(rng, rng.integers(3, 90, size=400))
    queries = [rng.integers(0, 20, size=n).astype(np.int8) for n in (20, 33)]
    jeng = JaxEngine(num_top=10, qcap=64, backend="jnp", mesh=jsh.make_mesh(),
                     max_device_bytes=1)
    jeng.set_database(JaxDBData(**fields))
    assert jeng.streaming
    want = _results(jeng.scan(q) for q in queries)
    eng = SearchEngine(num_top=10, mesh=_mesh(8), max_device_bytes=1)
    eng.set_database(DBData(**fields))
    assert eng.streaming and eng._resident_chunks == []
    assert _results(eng.scan(q) for q in queries) == want
    assert _results(eng.scan_many(queries)) == want
    resident = SearchEngine(num_top=10, mesh=_mesh(8))
    resident.set_database(DBData(**fields))
    assert not resident.streaming
    assert _results(resident.scan_many(queries)) == want


def test_streamed_mesh_partial_residency():
    """Partial residency on a mesh: each shard keeps its slice of whole
    leading chunks within its own budget (a pass's working memory and two
    chunk slices), the rest streams, and the results equal the resident
    engine's; the last chunk of the bucket splits at its real size."""
    rng = np.random.default_rng(99)
    db = DBData(**_fields(rng, rng.integers(20, 33, size=1400)))  # one row bucket, 11 tiles
    chunk = 4 * 4096  # 4 tiles of [32, 128] a chunk: 2 a shard
    shapes = [(b.L, b.NS, b.kernel, b.num_tiles) for b in tp.pack_db(db).buckets]
    assert shapes == [(32, 128, "row", 11)]
    work = es.stream_work_bytes(shapes, chunk, None, SearchEngine.QB_STREAM, 2)[0]
    slice_bytes = 2 * 128 * (32 + 4)
    eng = SearchEngine(num_top=5, mesh=_mesh(2), max_device_bytes=work + 2 * slice_bytes,
                       stream_chunk_bytes=chunk)
    eng.set_database(db)
    assert eng.streaming and eng._chunk_tiles(eng.packed.buckets[0]) == 4
    assert eng._res_tiles == {0: 8} and eng._prefix_bytes == 2 * slice_bytes
    (bi, parts), _ = eng._resident_chunks
    assert bi == 0 and [tuple(t.shape) for t, _ in parts] == [(2, 32, 128), (2, 32, 128)]
    assert shard_ranges(3, 2) == [(0, 2), (2, 3)]  # the streamed last chunk's split
    q = rng.integers(0, 20, size=25).astype(np.int8)
    got = _results([eng.scan(q)])
    assert eng.stream_copy_stats()["chunks"] == 2  # the last chunk's two slices
    resident = SearchEngine(num_top=5, device="cpu")
    resident.set_database(db)
    assert got == _results([resident.scan(q)])


def _lower(mp):
    mp.setattr(tp, "CELL_MAX_L", 48)
    mp.setattr(tp, "COL_SPEEDUP", 1e9)
    mp.setattr(sw_col, "NQC", 24)


@pytest.fixture
def lowered(monkeypatch):
    _lower(monkeypatch)


@pytest.fixture(scope="module")
def col_db():
    """A row bucket of 5 tiles, a cell and a col (L = 128) bucket of one
    (COL_SPEEDUP raised, as tests/test_streaming_mesh.py does), queries of
    20, 30 (past the lowered NQC) and 17 aa, and the single device's
    results on them."""
    rng = np.random.default_rng(1234)
    db = DBData(**_fields(rng, np.concatenate([
        rng.integers(5, 33, size=600), rng.integers(33, 49, size=4000),
        rng.integers(66, 90, size=120)])))
    queries = [rng.integers(0, 20, size=n).astype(np.int8) for n in (20, 30, 17)]
    with pytest.MonkeyPatch.context() as mp:
        _lower(mp)
        single = SearchEngine(num_top=10, device="cpu")
        single.set_database(db)
        assert [(b.kernel, b.num_tiles) for b in single.packed.buckets] == [
            ("row", 5), ("cell", 1), ("col", 1)]
        want = _results(single.scan(q) for q in queries)
    return db, queries, want


def test_resident_mesh_long_query_col_carry(col_db, lowered):
    """A resident mesh scan of a query past NQC: the col bucket's NQC
    chunks carry H/F on the shard that holds it."""
    db, queries, want = col_db
    eng = SearchEngine(num_top=10, mesh=_mesh(2))
    eng.set_database(db)
    assert not eng.streaming
    before = sw_col.score_bucket_col.plain_calls
    assert _results([eng.scan(queries[1])]) == want[1:2]
    assert sw_col.score_bucket_col.plain_calls - before >= 2  # two NQC chunks


def test_streamed_mesh_batch_mixed_lengths(col_db, lowered):
    """One streamed pass on a mesh serves short and long queries together
    (B4/B5/B2 for the short ones, the col carry for the long one, on every
    chunk slice of every shard); scan() of the long one shares the pass's
    pipeline and gives the same hits."""
    db, queries, want = col_db
    eng = SearchEngine(num_top=10, mesh=_mesh(2), max_device_bytes=1,
                       stream_chunk_bytes=2 * 32 * 128)
    eng.set_database(db)
    assert eng.streaming and eng._chunk_tiles(eng.packed.buckets[0]) == 2
    before = sw_cell.score_bucket_cell_batch.plain_calls, sw_col.score_bucket_col_flat.plain_calls
    assert _results(eng.scan_batch(queries)) == want
    after = sw_cell.score_bucket_cell_batch.plain_calls, sw_col.score_bucket_col_flat.plain_calls
    assert after[0] > before[0] and after[1] > before[1]
    assert _results([eng.scan(queries[1])]) == want[1:2]


def test_streamed_single_scan_equals_batch_on_mesh(col_db, lowered):
    db, queries, want = col_db
    eng = SearchEngine(num_top=10, mesh=_mesh(3), max_device_bytes=1)
    eng.set_database(db)
    single = eng.scan(queries[1])
    batch = eng.scan_batch([queries[1]])[0]
    assert (single.scores, single.reference_ids) == (batch.scores, batch.reference_ids)
    assert (single.scores, single.reference_ids) == want[1]


def test_resident_mesh_batch_col_bucket(col_db, lowered):
    """scan_batch on a resident mesh with a col bucket: the flat-pool col
    kernel scores the batch's slots on each shard."""
    db, queries, want = col_db
    eng = SearchEngine(num_top=10, mesh=_mesh(2))
    eng.set_database(db)
    short = [queries[0], queries[2]]
    before = sw_col.score_bucket_col_flat.plain_calls
    assert _results(eng.scan_batch(short)) == [want[0], want[2]]
    assert sw_col.score_bucket_col_flat.plain_calls > before
