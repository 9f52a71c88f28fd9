"""Per-host partial tile stores of the port on the CPU against the JAX
package's (tests/test_host_ranges.py).

A streamed mesh across processes reads only its shards' rows of each
chunk, so ``pack_db_to_store(tile_ranges=...)`` packs only those tiles into
a sparse file of the full size, ``load_packed`` checks that a store covers
what a caller reads, and a second process extends a shared store in place.
The range helpers are held against the JAX package's on random ranges; the
store, its npz manifest (with the write time that zip headers record held
fixed) and its b32 sidecar against the JAX package's files byte for byte,
built partial, then extended; ``_host_tile_ranges`` of a two-process mesh
against the rows each process's shards stage.
"""

import os
import time
import types
import zipfile

import numpy as np
import pytest

import cudasw4_tpu.db.packing as jp
from cudasw4_tpu.db.format import DBData as JaxDBData
import cudasw4_tpu_torch.db.packing as tp
from cudasw4_tpu_torch.db.format import DBData
from cudasw4_tpu_torch.engine import SearchEngine
from cudasw4_tpu_torch.parallel.sharding import Mesh, shard_ranges


def _fields(n=2500, seed=5):
    rng = np.random.default_rng(seed)
    lengths = np.sort(rng.integers(10, 60, size=n)).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum((lengths + 3) // 4 * 4)]).astype(np.uint64)
    return dict(chars=rng.integers(0, 20, size=int(offsets[-1])).astype(np.int8),
                offsets=offsets, lengths=lengths,
                headers=np.frombuffer(b"h" * n, dtype=np.uint8),
                header_offsets=np.arange(n + 1, dtype=np.uint64))


def _tiles_per_bucket(db):
    return [-(-(stop - start) // NS)
            for start, stop, _, NS, _ in tp.plan_buckets(np.asarray(db.lengths, np.int64))]


def _halves(Ts):
    return ([[(0, T // 2)] if T else [] for T in Ts],
            [[(T // 2, T)] if T else [] for T in Ts])


def _tree(path):
    """{name: bytes} of a store: its npz, tiles and sidecar files."""
    out = {}
    for name in (path, path + ".tiles"):
        with open(name, "rb") as f:
            out[os.path.basename(name)] = f.read()
    side = path + ".pack5"
    for name in sorted(os.listdir(side)) if os.path.isdir(side) else []:
        with open(os.path.join(side, name), "rb") as f:
            out["pack5/" + name] = f.read()
    return out


@pytest.fixture
def pinned_zip_time(monkeypatch):
    """Hold the time zipfile writes into npz member headers fixed."""
    monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(
        time=lambda: 1_700_000_000.0, localtime=time.localtime))


def test_range_helpers_equal_jax():
    """_norm_ranges, _ranges_cover and _ranges_subtract against the JAX
    package's on random ranges, and its own cases."""
    rng = np.random.default_rng(3)
    for _ in range(300):
        T = int(rng.integers(0, 40))
        a = [tuple(int(x) for x in rng.integers(-3, 45, size=2)) for _ in range(rng.integers(0, 6))]
        b = [tuple(int(x) for x in rng.integers(-3, 45, size=2)) for _ in range(rng.integers(0, 6))]
        assert tp._norm_ranges(a, T) == jp._norm_ranges(a, T)
        na, nb = tp._norm_ranges(a, T), tp._norm_ranges(b, T)
        assert tp._ranges_cover(na, nb) == jp._ranges_cover(na, nb)
        assert tp._ranges_subtract(na, nb) == jp._ranges_subtract(na, nb)
    assert tp._norm_ranges([(5, 3), (1, 4), (4, 7), (10, 12)], 11) == [(1, 7), (10, 11)]
    assert tp._ranges_cover([(0, 4), (6, 10)], [(1, 3), (7, 9)])
    assert not tp._ranges_cover([(0, 4), (6, 10)], [(2, 7)])
    assert tp._ranges_subtract([(0, 10)], [(2, 5)]) == [(0, 2), (5, 10)]


def test_partial_store_built_loaded_extended_like_jax(tmp_path, pinned_zip_time, monkeypatch):
    """A partial store with its b32 sidecar, built, loaded and extended,
    equals the JAX package's files byte for byte at every step; it holds
    the pack's tiles in its ranges and zeros elsewhere (a sparse file);
    loads take it only for ranges it covers; the extension completes it.
    Both packages pack with their Python packers (the database's padding
    bytes are random codes, which the Python packer keeps and the native
    one overwrites with the pad code)."""
    monkeypatch.setenv("CUDASW4_TPU_TORCH_NATIVE", "0")
    fields = _fields()
    db, jdb = DBData(**fields), JaxDBData(**fields)
    n, nch = db.num_sequences, int(db.lengths.sum())
    Ts = _tiles_per_bucket(db)
    lo, hi = _halves(Ts)
    t, j = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    pk = tp.pack_db_to_store(db, t, tile_ranges=lo, stream_codec="b32")
    jp.pack_db_to_store(jdb, j, tile_ranges=lo, stream_codec="b32", use_native=False)
    assert list(_tree(t).values()) == list(_tree(j).values())
    assert pk.tile_ranges == [tp._norm_ranges(r, T) for r, T in zip(lo, Ts)]
    ref = tp.pack_db(db)
    for b_ref, b_got, T in zip(ref.buckets, pk.buckets, Ts):
        assert np.array_equal(b_ref.tiles[: T // 2], b_got.tiles[: T // 2])
        assert not np.asarray(b_got.tiles[T // 2 :]).any()
        assert np.array_equal(b_ref.seq_index, b_got.seq_index)
        assert np.array_equal(b_ref.lengths, b_got.lengths)
    st = os.stat(t + ".tiles")
    assert st.st_blocks * 512 < os.path.getsize(t + ".tiles")
    assert tp.load_packed(t, n, nch) is None
    assert tp.load_packed(t, n, nch, need_ranges=hi) is None
    assert tp.load_packed(t, n, nch, need_ranges=lo).tile_ranges == pk.tile_ranges
    assert tp.load_packed(t, n, nch, need_ranges="any") is not None
    layout = [(b.L, b.NS, b.kernel, b.num_tiles) for b in ref.buckets]
    man = tp.stream_manifest("b32", 20, n, nch, layout)
    assert tp.stream_sidecar_fresh(t, man, need_ranges=lo)
    assert not tp.stream_sidecar_fresh(t, man, need_ranges=hi)
    assert not tp.stream_sidecar_fresh(t, man)
    # A second process extends the shared store with the other halves.
    full = tp.pack_db_to_store(db, t, tile_ranges=hi, stream_codec="b32")
    jp.pack_db_to_store(jdb, j, tile_ranges=hi, stream_codec="b32", use_native=False)
    assert list(_tree(t).values()) == list(_tree(j).values())
    assert full.tile_ranges is None and tp.stream_sidecar_fresh(t, man)
    for b_ref, b_got in zip(ref.buckets, tp.load_packed(t, n, nch).buckets):
        assert np.array_equal(b_ref.tiles, b_got.tiles)


def test_resident_engine_extends_a_partial_store(tmp_path):
    """A partial store never feeds a resident engine: set_database, finding
    the database resident, extends the store to every tile first."""
    fields = _fields(1200, seed=3)
    db = DBData(**fields)
    lo, _ = _halves(_tiles_per_bucket(db))
    path = str(tmp_path / "g.npz")
    tp.pack_db_to_store(db, path, tile_ranges=lo)
    n, nch = db.num_sequences, int(db.lengths.sum())
    assert tp.load_packed(path, n, nch) is None
    eng = SearchEngine(num_top=5, device="cpu")
    eng.set_database(db, pack_cache=path)
    assert not eng.streaming and eng.packed.tile_ranges is None
    assert tp.load_packed(path, n, nch) is not None
    q = np.random.default_rng(0).integers(0, 20, 30).astype(np.int8)
    plain = SearchEngine(num_top=5, device="cpu")
    plain.set_database(db)
    got, want = eng.scan(q), plain.scan(q)
    assert (got.scores, got.reference_ids) == (want.scores, want.reference_ids)


def test_host_tile_ranges_of_a_two_process_mesh(tmp_path):
    """On a 4-shard mesh of two processes (positions 0-1 and 2-3), each
    process's ranges are its shards' slices of every chunk, the two
    disjoint and together every tile; one process alone, or a single
    device, needs every tile (None).  A per-host store built from them
    serves the streamed scan of that process's shards."""
    fields = _fields(3200, seed=2025)
    db = DBData(**fields)
    plans = tp.plan_buckets(np.asarray(db.lengths, np.int64))
    Ts = _tiles_per_bucket(db)
    got = {}
    for rank in (0, 1):
        mesh = Mesh(["cpu"] * 4, local=(2 * rank, 2 * rank + 1))
        eng = SearchEngine(num_top=5, mesh=mesh, max_device_bytes=1,
                           stream_chunk_bytes=6 * 32 * 128)
        got[rank] = eng._host_tile_ranges(plans)
        for (start, stop, L, NS, _), rs, T in zip(plans, got[rank], Ts):
            ct = eng._chunk_tiles(types.SimpleNamespace(L=L, NS=NS, num_tiles=T))
            assert ct % 4 == 0
            want = []
            for t0 in range(0, T, ct):
                split = shard_ranges(min(ct, T - t0), 4)
                want += [(t0 + split[p][0], t0 + split[p][1]) for p in mesh.local]
            assert rs == tp._norm_ranges(want, T)
    for r0, r1, T in zip(got[0], got[1], Ts):
        assert tp._ranges_subtract(tp._norm_ranges(r0 + r1, T), [(0, T)]) == []
        assert tp._norm_ranges(r0 + r1, T) == [(0, T)]
        assert all(tp._ranges_subtract([x], r1) == [x] for x in r0)  # disjoint
    assert any(r != [(0, T)] for r, T in zip(got[0], Ts))
    one = SearchEngine(num_top=5, mesh=Mesh(["cpu"] * 4), max_device_bytes=1)
    assert one._host_tile_ranges(plans) is None
    assert SearchEngine(num_top=5, device="cpu")._host_tile_ranges(plans) is None
    # Process 1's store: only its rows, and a streamed pass of its shards
    # stages nothing outside them.
    mesh = Mesh(["cpu"] * 4, local=(2, 3))
    eng = SearchEngine(num_top=5, mesh=mesh, max_device_bytes=1,
                       stream_chunk_bytes=6 * 32 * 128)
    eng.set_database(db, pack_cache=str(tmp_path / "p1.npz"))
    assert eng.streaming and eng.packed.tile_ranges == got[1]
    staged = []
    real = eng._stream_chunks

    def spy():
        for b, chunk, sidx in real():
            staged.append((b, sidx))
            yield b, chunk, sidx

    eng._stream_chunks = spy
    list(eng._stream_candidates_mesh([np.arange(12, dtype=np.int8)]).host()[0])
    ref = tp.pack_db(db)
    for b, sidx in staged:
        bi = next(i for i, x in enumerate(eng.packed.buckets) if x is b)
        split = shard_ranges(len(sidx), 4)
        first = int(np.nonzero((ref.buckets[bi].seq_index == sidx[0]).all(axis=1))[0][0])
        for p in mesh.local:
            a, e = split[p]
            if e > a:
                assert tp._ranges_cover(got[1][bi], [(first + a, first + e)])
