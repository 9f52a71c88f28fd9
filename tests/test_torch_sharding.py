"""The port's mesh (parallel/sharding.py and the engine's mesh branches) on
the CPU against the JAX package's virtual 8-device CPU mesh
(tests/conftest.py) and against the port's single device.

The port's mesh is n shards on the CPU (``make_mesh(["cpu"] * n)``), each
running the plain versions of the kernels on its slice of every bucket.
Two databases: tests/test_sharding.py's (60 random sequences packed into
row buckets of one tile each, the JAX engine's jnp scorer), where the
port's mesh meets the JAX mesh and the port's single device; and one of
three bucket kinds with several tiles each (CELL_MAX_L lowered to 48 and
NQC to 24 in the port, as tests/test_torch_engine.py does), where every
shard holds tiles of every kind: singles, a query past NQC (the col carry
on each shard), batches (B4, B5, B2 on each shard), and int16 state with
SAT lowered so that tiles flag on several shards (the mesh re-score, and
the exact re-scan past OVF_TILE_CAP).  Tolerance: exact scores, ids and
order.
"""

import jax
import numpy as np
import pytest
import torch

from cudasw4_tpu.db.format import DBData as JaxDBData
from cudasw4_tpu.db.format import pseudo_to_dbdata as jax_pseudo_to_dbdata
from cudasw4_tpu.db.pseudo import make_pseudo_db as jax_make_pseudo_db
from cudasw4_tpu import ops as jax_ops
from cudasw4_tpu.engine import SearchEngine as JaxEngine
from cudasw4_tpu.ops import sw_pallas_cell
from cudasw4_tpu.parallel import sharding as jsh
import cudasw4_tpu_torch.db.packing as tp
from cudasw4_tpu_torch.db.format import DBData, pseudo_to_dbdata
from cudasw4_tpu_torch.db.pseudo import make_pseudo_db
from cudasw4_tpu_torch.engine import SearchEngine
from cudasw4_tpu_torch.ops import sw_cell, sw_col
from cudasw4_tpu_torch.parallel.sharding import (
    Mesh, make_mesh, merge_topk, shard_ranges, top_n,
)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(rng, lengths):
    """DB fields of random sequences of sorted ``lengths``."""
    lens = np.sort(np.asarray(lengths)).astype(np.int32)
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum((lens + 3) // 4 * 4, out=offsets[1:])
    chars = np.full(int(offsets[-1]), 20, np.int8)
    for a, n in zip(offsets[:-1], lens):
        chars[a : a + n] = rng.integers(0, 20, size=int(n))
    names = [b"s%d" % i for i in range(len(lens))]
    hoff = np.zeros(len(lens) + 1, np.uint64)
    np.cumsum([len(x) for x in names], out=hoff[1:])
    return dict(chars=chars, offsets=offsets.astype(np.uint64), lengths=lens,
                headers=np.frombuffer(b"".join(names), np.uint8), header_offsets=hoff)


def _results(rs):
    return [(r.scores, r.reference_ids) for r in rs]


def _mesh_engine(db, n, **kw):
    eng = SearchEngine(mesh=make_mesh(["cpu"] * n), **kw)
    eng.set_database(db)
    return eng


@pytest.fixture(scope="module")
def small():
    """tests/test_sharding.py's database and queries, and the JAX 8-device
    mesh's results on them."""
    rng = np.random.default_rng(1234)
    fields = _fields(rng, rng.integers(3, 90, size=60))
    queries = [rng.integers(0, 20, size=n).astype(np.int8) for n in (30, 4, 17)]
    jeng = JaxEngine(num_top=10, qcap=64, mesh=jsh.make_mesh())
    jeng.set_database(JaxDBData(**fields))
    return fields, queries, _results(jeng.scan(q) for q in queries)


@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_mesh_equals_jax_mesh_and_single(small, ndev):
    fields, queries, want = small
    db = DBData(**fields)
    single = SearchEngine(num_top=10, device="cpu")
    single.set_database(db)
    assert _results(single.scan(q) for q in queries) == want
    eng = _mesh_engine(db, ndev, num_top=10)
    assert not eng.streaming and len(eng._shards) == ndev
    assert _results(eng.scan(q) for q in queries) == want
    assert _results(eng.scan_many(queries)) == want


def test_mesh_pseudo_db_ties_equal_jax():
    """Identical sequences: every score ties, and the mesh returns the
    lowest ids in order, as the JAX mesh does."""
    jeng = JaxEngine(num_top=4, qcap=64, mesh=jsh.make_mesh())
    jeng.set_database(jax_pseudo_to_dbdata(jax_make_pseudo_db(10, 40)))
    want = jeng.scan("ARNDCQEGHILKMFPSTWYV")
    eng = _mesh_engine(pseudo_to_dbdata(make_pseudo_db(10, 40)), 8, num_top=4)
    got = eng.scan("ARNDCQEGHILKMFPSTWYV")
    assert (got.scores, got.reference_ids) == (want.scores, want.reference_ids)
    assert len(set(got.scores)) == 1 and got.reference_ids == [0, 1, 2, 3]


def test_mesh_top_exceeds_shard():
    """num_top larger than any shard's real sequences (10 over 8 shards)."""
    rng = np.random.default_rng(5)
    fields = _fields(rng, rng.integers(3, 90, size=10))
    jeng = JaxEngine(num_top=10, qcap=64, mesh=jsh.make_mesh())
    jeng.set_database(JaxDBData(**fields))
    want = jeng.scan("ARND")
    eng = _mesh_engine(DBData(**fields), 8, num_top=10)
    got = eng.scan("ARND")
    assert (got.scores, got.reference_ids) == (want.scores, want.reference_ids)
    assert sorted(got.reference_ids) == list(range(10))


def test_merge_cross_shard_ties_equal_jax():
    """Equal scores across shards go to the lowest id: shard order is not
    id order once there are several buckets, so the merge sorts by
    (-score, id), as the JAX package's _merge_topk does."""
    from jax.sharding import PartitionSpec as P

    scores = [[9.0, 5.0], [9.0, 8.0]]
    ids = [[5000, 7], [100, 3]]
    parts = [top_n(torch.tensor(s), torch.tensor(i, dtype=torch.int64), 3)
             for s, i in zip(scores, ids)]
    vals = np.stack([v.numpy()[None] for v, _ in parts])
    idx = np.stack([i.numpy()[None] for _, i in parts])
    v, i = merge_topk(vals, idx, 3)
    assert v.tolist() == [[9, 9, 8]] and i.tolist() == [[100, 5000, 3]]
    fn = jax.jit(jax.shard_map(
        lambda s, i: jsh._merge_topk(s, i, 3, "d"), mesh=jsh.make_mesh(jax.devices()[:2]),
        in_specs=(P("d"), P("d")), out_specs=(P(), P()), check_vma=False,
    ))
    jv, ji = fn(np.asarray(scores, np.float32).reshape(-1),
                np.asarray(ids, np.int32).reshape(-1))
    assert [int(x) for x in jv] == v[0].tolist() and [int(x) for x in ji] == i[0].tolist()
    # k = 0 still selects one; padding (-1 ids) never comes out.
    assert merge_topk(np.array([[[4, -1]]]), np.array([[[2, -1]]]), 0)[1].tolist() == [[2]]


def test_shard_ranges_and_mesh_construction():
    """The JAX package's tile split without its pad tiles; make_mesh with
    no device named needs a card (this machine has none)."""
    assert shard_ranges(5, 2) == [(0, 3), (3, 5)]
    assert shard_ranges(1, 3) == [(0, 1), (1, 1), (1, 1)]
    assert shard_ranges(0, 2) == [(0, 0), (0, 0)]
    for T in range(9):
        for nd in (1, 2, 3, 8):
            rs = shard_ranges(T, nd)
            assert rs[0][0] == 0 and rs[-1][1] == T
            assert all(a[1] == b[0] for a, b in zip(rs, rs[1:]))
    mesh = make_mesh(["cpu", "cpu"])
    assert mesh.size == 2 and mesh.local == (0, 1) and not mesh.multiprocess
    assert Mesh(["cpu"] * 4, local=(2, 3)).multiprocess
    x = np.arange(6).reshape(2, 3)
    assert mesh.gather(x) is not None and np.array_equal(mesh.gather(x), x)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh()
        with pytest.raises(RuntimeError):
            make_mesh(["cuda:0"])


# ------------------------------------------------- three kinds, multi-tile

def _lower(mp):
    mp.setattr(tp, "CELL_MAX_L", 48)
    mp.setattr(sw_col, "NQC", 24)


@pytest.fixture
def lowered(monkeypatch):
    _lower(monkeypatch)


@pytest.fixture(scope="module")
def multi():
    """A database of a row (3 tiles), a cell (2 tiles) and a col bucket
    (2 tiles, L = 128) under CELL_MAX_L = 48, four copies of one sequence
    (ties across shards), queries (the tied one, short ones that batch and
    one past the lowered NQC), and the single device's results."""
    rng = np.random.default_rng(91)
    db = DBData(**_fields(rng, np.concatenate([
        rng.integers(5, 33, size=300), rng.integers(33, 49, size=7800),
        rng.integers(49, 129, size=4200),
    ])))
    tie = db.get_sequence(9000).copy()
    for i in np.nonzero(db.lengths == len(tie))[0][:4]:
        db.chars[int(db.offsets[i]) : int(db.offsets[i]) + len(tie)] = tie
    queries = [tie[:20]] + [rng.integers(0, 20, size=n).astype(np.int8) for n in (12, 30, 7)]
    with pytest.MonkeyPatch.context() as mp:
        _lower(mp)
        single = SearchEngine(num_top=9, device="cpu")
        single.set_database(db)
        want = _results(single.scan(q) for q in queries)
    return db, queries, want


@pytest.mark.parametrize("ndev", [2, 3])
def test_mesh_scans_equal_single_on_every_kind(multi, lowered, ndev):
    """scan_many (a batch of the three short ones, the 30-aa one alone
    with the col carry on each shard), scan and scan_batch on a mesh whose
    shards hold tiles of every bucket kind (of some, with 3 shards) equal
    the single device's."""
    db, queries, want = multi
    eng = _mesh_engine(db, ndev, num_top=9)
    assert [(b.kernel, b.num_tiles) for b in eng.packed.buckets] == [
        ("row", 3), ("cell", 2), ("col", 2)]
    assert [[t is not None for t in sh.tiles] for sh in eng._shards] == (
        [[True] * 3, [True] * 3] if ndev == 2 else [[True] * 3, [True] * 3, [True, False, False]])
    batch_before = sw_cell.score_bucket_cell_batch.plain_calls
    assert _results(eng.scan_many(queries)) == want
    # Two batches (the 30-aa query runs alone between them), each on the
    # two shards that hold the cell bucket.
    assert sw_cell.score_bucket_cell_batch.plain_calls == batch_before + 2 * 2
    before = sw_col.score_bucket_col.plain_calls
    assert _results([eng.scan(queries[2])]) == want[2:3]
    assert sw_col.score_bucket_col.plain_calls == before + 2 * 2  # 2 chunks on 2 shards
    short = [queries[i] for i in (0, 1, 3)]
    assert _results(eng.scan_batch(short)) == [want[i] for i in (0, 1, 3)]
    scores, ids = want[0]
    assert scores[:4] == [scores[0]] * 4 and ids[:4] == sorted(ids[:4])


def test_mesh_state16_rescore_and_fallback(multi, lowered, monkeypatch):
    """int16 state with SAT lowered to the lowest top score: every query
    flags tiles, on both shards, the mesh re-scores only them, and the hits
    equal the exact single device's; with OVF_TILE_CAP at 0 every query is
    scanned again in exact state instead, with the same hits."""
    db, queries, want = multi
    eng = _mesh_engine(db, 2, num_top=9)
    eng.state16 = True
    monkeypatch.setattr(sw_cell, "SAT", min(s[0] for s, _ in want))
    flagged, rescans = [], []
    real_rescore, real_dispatch = eng._rescore_overflow_mesh, eng._dispatch_mesh

    def rescore(tmaxes, vals, ids, codes):
        flagged.append([sum(int((t >= sw_cell.SAT).sum()) for t in per) for per in tmaxes])
        return real_rescore(tmaxes, vals, ids, codes)

    def dispatch(codes, exact):
        rescans.append(exact)
        return real_dispatch(codes, exact)

    monkeypatch.setattr(eng, "_rescore_overflow_mesh", rescore)
    monkeypatch.setattr(eng, "_dispatch_mesh", dispatch)
    got = [eng.scan(q) for q in queries]
    assert _results(got) == want
    assert len(flagged) == len(queries) and all(r.stats.num_overflows > 0 for r in got)
    assert any(all(n > 0 for n in per) for per in flagged)  # tiles flag on both shards
    assert rescans == [False] * len(queries)  # within the cap: no exact re-scan
    rescans.clear()
    monkeypatch.setattr(SearchEngine, "OVF_TILE_CAP", 0)
    assert _results(eng.scan(q) for q in queries) == want
    assert rescans == [False, True] * len(queries)


def test_mesh_state16_equals_jax_mesh_at_lowered_sat(monkeypatch):
    """At SAT = 30 (as tests/test_overflow.py lowers it) the hits of a
    two-tile row bucket saturate on both shards: the port's mesh re-score
    gives the JAX mesh's results and overflow counts (the JAX engine's
    int16 state needs its Pallas backend, run in interpret mode)."""
    rng = np.random.default_rng(12)
    fields = _fields(rng, rng.integers(33, 49, size=200))
    queries = [rng.integers(0, 20, size=n).astype(np.int8) for n in (25, 9)]
    monkeypatch.setattr(sw_pallas_cell, "SAT", 30)
    monkeypatch.setattr(sw_cell, "SAT", 30)
    monkeypatch.setattr(jax_ops, "INTERPRET", True)
    jeng = JaxEngine(num_top=10, qcap=64, backend="pallas",
                     mesh=jsh.make_mesh(jax.devices()[:2]))
    jeng.state16 = True
    jeng.set_database(JaxDBData(**fields))
    want = [jeng.scan(q) for q in queries]
    eng = _mesh_engine(DBData(**fields), 2, num_top=10)
    assert [(b.kernel, b.num_tiles) for b in eng.packed.buckets] == [("row", 2)]
    eng.state16 = True
    got = [eng.scan(q) for q in queries]
    assert _results(got) == _results(want)
    assert [r.stats.num_overflows for r in got] == [r.stats.num_overflows for r in want]
    assert got[0].stats.num_overflows > 0
