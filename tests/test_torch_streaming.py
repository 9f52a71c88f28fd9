"""The port's streaming engine, transfer codecs and tile store on the CPU
against the JAX package's.

One database of ~4k sequences packs into a row, a cell and a col bucket
(CELL_MAX_L lowered to 48 in both packages, so the 49..128-aa tail packs
into a col bucket of L = 128); its 20 queries include one of its
sequences, planted at three more places (ties), and queries longer than
the port's lowered NQC (24),
which is its ``_qcap_batch`` here, so that they run one by one with the
col carry while the others share the batch kernels.  The JAX engine
streams the same database (``max_device_bytes=1``) and scores the 20
queries once per module, as its own tests run it
(tests/test_engine.py:137-200, tests/test_pack5.py:106-250).  The words of
both codecs, the store's files and the sidecar's files are compared byte
for byte; the npz manifests with the write time that their zip headers
record held fixed.  Tolerance: exact scores, ids and order.
"""

import os
import time
import types
import zipfile

import numpy as np
import pytest
import torch

import cudasw4_tpu.db.packing as jp
import cudasw4_tpu.ops.pack5 as jpack5
from cudasw4_tpu import make_scoring_config as jax_scoring
from cudasw4_tpu.cli import makedb as jax_makedb
from cudasw4_tpu.db.format import DBData as JaxDBData
from cudasw4_tpu.engine import SearchEngine as JaxEngine
import cudasw4_tpu_torch.db.packing as tp
from cudasw4_tpu_torch import make_scoring_config
from cudasw4_tpu_torch.cli import align, makedb
from cudasw4_tpu_torch.db.format import DBData
from cudasw4_tpu_torch.engine import SearchEngine
from cudasw4_tpu_torch import engine_streaming as es
from cudasw4_tpu_torch.ops import pack5, sw_cell, sw_col

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
FIELDS = ("chars", "offsets", "lengths", "headers", "header_offsets")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _db(rng, lengths):
    """(port DBData, JAX DBData) of random sequences of sorted ``lengths``."""
    lens = np.sort(np.asarray(lengths)).astype(np.int32)
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum((lens + 3) // 4 * 4, out=offsets[1:])
    chars = np.full(int(offsets[-1]), 20, np.int8)
    for a, n in zip(offsets[:-1], lens):
        chars[a : a + n] = rng.integers(0, 20, size=int(n))
    names = [b"s%d" % i for i in range(len(lens))]
    hoff = np.zeros(len(lens) + 1, np.uint64)
    np.cumsum([len(x) for x in names], out=hoff[1:])
    fields = dict(chars=chars, offsets=offsets.astype(np.uint64), lengths=lens,
                  headers=np.frombuffer(b"".join(names), np.uint8), header_offsets=hoff)
    return DBData(**fields), JaxDBData(**fields)


def _three_kinds(rng):
    db, jdb = _db(rng, np.concatenate([
        rng.integers(5, 33, size=60),       # row bucket, L=32
        rng.integers(33, 49, size=2500),    # cell bucket, L=48
        rng.integers(49, 129, size=1500),   # col bucket, L=128
    ]))
    return db, jdb


def _lower(mp):
    mp.setattr(jp, "CELL_MAX_L", 48)
    mp.setattr(tp, "CELL_MAX_L", 48)
    mp.setattr(sw_col, "NQC", 24)


@pytest.fixture
def lowered(monkeypatch):
    _lower(monkeypatch)


#: The 20 queries: a database sequence of the col bucket, planted at three
#: more places of its length (ties), then these lengths; those past 24 run
#: one by one.
QUERY_LENGTHS = (23, 37, 8, 30, 12, 5, 44, 19, 26, 16, 9, 33, 21, 14, 60, 11, 24, 7, 28)


@pytest.fixture(scope="module")
def setup():
    """The database, its 20 queries and the JAX streaming engine's results."""
    rng = np.random.default_rng(71)
    db, jdb = _three_kinds(rng)
    tie = db.get_sequence(3000).copy()
    for i in np.nonzero(db.lengths == len(tie))[0][:4]:  # shared with jdb
        db.chars[int(db.offsets[i]) : int(db.offsets[i]) + len(tie)] = tie
    queries = [tie] + [rng.integers(0, 20, size=n).astype(np.int8) for n in QUERY_LENGTHS]
    with pytest.MonkeyPatch.context() as mp:
        _lower(mp)
        jeng = JaxEngine(scoring=jax_scoring("blosum62"), num_top=12, qcap=64,
                         max_device_bytes=1, stream_chunk_bytes=4096)
        jeng.set_database(jdb)
        assert jeng.streaming
        want = _results(jeng.scan_many(queries))
    return db, queries, want


def _results(rs):
    return [(r.scores, r.reference_ids) for r in rs]


def _streamed(db, **kw):
    eng = SearchEngine(scoring=make_scoring_config("blosum62"), num_top=12, device="cpu",
                       max_device_bytes=1, stream_chunk_bytes=4096, **kw)
    eng.set_database(db)
    assert eng.streaming and eng._qb_cap == 20
    return eng


def test_streamed_scans_equal_jax_and_resident(setup, lowered):
    """scan_many of the 20 (one pass), scan_batch and scan, streamed, and
    scan_many resident, all equal the JAX streaming engine's results."""
    db, queries, want = setup
    eng = _streamed(db)
    assert [b.kernel for b in eng.packed.buckets] == ["row", "cell", "col"]
    assert eng._qcap_batch == 24 and max(len(q) for q in queries) > 24
    before = sw_cell.score_bucket_cell_batch.plain_calls
    got = _results(eng.scan_many(queries))
    assert sw_cell.score_bucket_cell_batch.plain_calls == before + 1  # one pass: one batch a chunk
    assert got == want
    assert _results(eng.scan_batch(queries[:3])) == want[:3]
    assert _results([eng.scan(queries[7])]) == want[7:8]  # 44 aa: the col carry
    scores, ids = want[0]
    assert scores[0] == scores[1] and ids[:2] == sorted(ids[:2])
    resident = SearchEngine(scoring=make_scoring_config("blosum62"), num_top=12, device="cpu")
    resident.set_database(db)
    assert not resident.streaming
    assert _results(resident.scan_many(queries)) == want


def test_streamed_results_carry_seconds_and_state16(setup, lowered):
    """A streamed pass splits its wall seconds by cells, runs exact state
    under state16 too, and the engine refuses resident-only calls."""
    db, queries, want = setup
    eng = _streamed(db)
    eng.state16 = True
    eng.total_timer_start()
    before = sw_cell.score_bucket_cell.plain_calls16, sw_col.score_bucket_col.plain_calls16
    rs = list(eng.scan_many(queries[:4]))
    assert _results(rs) == want[:4]
    assert (sw_cell.score_bucket_cell.plain_calls16, sw_col.score_bucket_col.plain_calls16) == before
    ratio = rs[1].stats.seconds / rs[0].stats.seconds
    assert ratio == pytest.approx(len(queries[1]) / len(queries[0]))
    assert rs[0].stats.gcups == pytest.approx(rs[1].stats.gcups)
    assert eng.total_timer_stop().gcups > 0
    with pytest.raises(RuntimeError):
        eng.slot_scores(queries[0])
    with pytest.raises(ValueError):
        eng.scan_batch(queries + queries[:1])


@pytest.mark.parametrize("mode,codec", [("0", None), ("2", "b21"), ("1", "b32")])
def test_codecs_give_the_same_results(setup, lowered, monkeypatch, mode, codec):
    db, queries, want = setup
    monkeypatch.setenv("CUDASW4_TPU_TORCH_STREAM_PACK", mode)
    eng = _streamed(db)
    assert eng._stream_codec == codec and (eng._stream_pack is None) == (codec is None)
    chunks = list(eng._stream_chunks())
    assert all(c.dtype == (np.int8 if codec is None else np.int32) for _, c, _ in chunks)
    assert _results(eng.scan_batch([queries[i] for i in (0, 3, 7)])) == [want[i] for i in (0, 3, 7)]


def test_stream_error_propagates_and_the_next_pass_runs(setup, lowered):
    """An error reading a streamed chunk (a store gone under the engine)
    reaches the caller of scan, and the next pass scores as before."""
    db, queries, want = setup
    eng = _streamed(db)
    chunks = eng._stream_chunks

    def broken():
        yield next(chunks())
        raise OSError("store gone")

    eng._stream_chunks = broken
    with pytest.raises(OSError, match="store gone"):
        eng.scan(queries[0])
    eng._stream_chunks = chunks
    assert _results(eng.scan_batch(queries[:3])) == want[:3]
    assert eng.stream_copy_stats()["chunks"] == 3


def test_max_batch_sequences_caps_chunk_shapes(lowered):
    """--maxBatchSequences caps a chunk's subject slots (at least one
    tile); the chunk shapes change, the results do not."""
    rng = np.random.default_rng(72)
    db, _ = _db(rng, rng.integers(5, 33, size=600))  # one row bucket of 5 tiles

    def shapes(**kw):
        eng = SearchEngine(device="cpu", num_top=5, max_device_bytes=1,
                           stream_chunk_bytes=1 << 20, **kw)
        eng.set_database(db)
        return eng, [c.shape for _, c, _ in eng._stream_chunks()]

    wide, uncapped = shapes()
    capped_eng, capped = shapes(max_batch_sequences=256)
    assert [b.kernel for b in wide.packed.buckets] == ["row"]
    assert len(uncapped) == 1 and len(capped) == 3
    assert all(s[0] * 128 <= 256 for s in capped)
    q = rng.integers(0, 20, size=17).astype(np.int8)
    assert _results([capped_eng.scan(q)]) == _results([wide.scan(q)])


def _shapes(packed):
    return [(b.L, b.NS, b.kernel, b.num_tiles) for b in packed.buckets]


def test_resident_prefix_pinned_and_dropped(monkeypatch):
    """At a budget of a pass's working memory and a few chunks, the leading
    whole chunks (tiles and seq_index) stay resident, the rest streams, the
    results equal the resident engine's; a second set_database drops the
    prefix and the transfer pack.  CUDASW4_TPU_TORCH_STREAM_RESIDENT=0
    pins none."""
    rng = np.random.default_rng(73)
    db, _ = _db(rng, rng.integers(20, 33, size=40_000))  # one cell bucket, 10 tiles of 128 KB
    chunk = 32 * 4096 + 4 * 4096  # one tile and its seq_index
    work = es.stream_work_bytes(_shapes(tp.pack_db(db)), 100_000)[0]
    eng = SearchEngine(device="cpu", num_top=6, max_device_bytes=work + 3 * chunk + 5,
                       stream_chunk_bytes=100_000)
    eng.set_database(db)
    b = eng.packed.buckets[0]
    assert b.kernel == "cell" and b.num_tiles == 10 and eng.streaming
    assert eng._work_bytes == work and eng._res_tiles == {0: 3}
    assert len(eng._resident_chunks) == 3 and eng._prefix_bytes == 3 * chunk
    assert eng._prefix_bytes <= eng._prefix_budget()
    assert eng.stream_copy_stats()["chunks"] == 0
    q = rng.integers(0, 20, size=12).astype(np.int8)
    got = _results([eng.scan(q)])
    assert eng.stream_copy_stats()["chunks"] == 7
    resident = SearchEngine(device="cpu", num_top=6)
    resident.set_database(db)
    assert got == _results([resident.scan(q)])
    monkeypatch.setenv("CUDASW4_TPU_TORCH_STREAM_RESIDENT", "0")
    eng.set_database(db)
    assert eng.streaming and eng._resident_chunks == [] and eng._res_tiles == {}
    small, _ = _db(rng, rng.integers(20, 33, size=50))
    eng.set_database(small)
    assert not eng.streaming and eng._resident_chunks == [] and eng._stream_pack is None
    assert len(eng._bucket_tiles) == 1 and eng._temp_bytes is None


def test_second_database_drops_the_resident_ids():
    """A streamed database after a resident one keeps no id map of the old
    one on the device."""
    rng = np.random.default_rng(81)
    db, _ = _db(rng, rng.integers(20, 33, size=500))
    eng = SearchEngine(device="cpu", num_top=4)
    eng.set_database(db)
    assert eng._flat_idx is not None and eng._valid is not None
    eng.max_device_bytes = 1
    eng.set_database(db)
    assert eng.streaming and eng._flat_idx is None and eng._valid is None


#: Bucket shapes (L, NS, kind, T) of the work-model cases: cell only, row
#: and cell, and with a long col bucket.
WORK_SHAPES = {
    "cell": [(64, 4096, "cell", 3)],
    "row_cell": [(32, 128, "row", 5), (96, 4096, "cell", 2)],
    "col": [(48, 4096, "cell", 4), (256, 4096, "col", 2), (1024, 4096, "col", 1)],
}


@pytest.mark.parametrize("name", sorted(WORK_SHAPES))
def test_stream_work_bytes_counts_the_pass(name):
    """The working memory of a pass, counted by hand: the ring's two
    chunks and their seq_index, four chunks of tiles, 32 bytes a slot and
    query and 8 a slot, the small buffers, and the largest one-tile kernel
    temporaries (col: B3's carry in and out with NQC boundary rows)."""
    shapes = WORK_SHAPES[name]
    chunk_bytes = 200_000
    cts = [es.chunk_tiles(L, NS, T, chunk_bytes, None) for L, NS, _, T in shapes]
    tiles = max(ct * L * NS for ct, (L, NS, _, _) in zip(cts, shapes))
    slots = max(ct * NS for ct, (_, NS, _, _) in zip(cts, shapes))
    temp = 0
    if name == "col":
        temp = 16 * 1024 * 4096 + 2 * 4096 * sw_col.NQC * 4
    work, got_temp = es.stream_work_bytes(shapes, chunk_bytes, None, 20)
    assert got_temp == temp
    assert work == 2 * (tiles + 4 * slots) + 4 * tiles + slots * (32 * 20 + 8) + (4 << 20) + temp
    assert es.stream_work_bytes(shapes, chunk_bytes, 128, 20)[0] <= work


@pytest.mark.parametrize("spare,streams", [(0, False), (-1, True)])
def test_database_streams_past_its_tiles_and_work(tmp_path, spare, streams):
    """A database streams when its tiles and a pass's working memory pass
    the budget, and stays resident at exactly that sum; makedb
    --prepackStream builds the transfer sidecar by the same rule (at the
    default chunk caps)."""
    from cudasw4_tpu_torch.db.format import load_db

    fa = tmp_path / "db.fa"
    fa.write_text("".join(f">s{i}\n{'ACDEFGHIKL'[: 5 + i % 6] * (1 + i % 9)}\n"
                          for i in range(300)))
    prefix = str(tmp_path / "db")
    assert makedb.run([str(fa), prefix]) == 0
    db = load_db(prefix)
    shapes = _shapes(tp.pack_db(db))
    padded = sum(L * NS * T for L, NS, _, T in shapes)
    need = padded + es.stream_work_bytes(shapes, 4096)[0]
    eng = SearchEngine(device="cpu", num_top=4, max_device_bytes=need + spare,
                       stream_chunk_bytes=4096)
    eng.set_database(db)
    assert eng.streaming == streams and es.streams(shapes, need + spare, 4096) == streams
    budget = padded + es.stream_work_bytes(shapes)[0] + spare
    assert makedb.run([str(fa), prefix, "--prepackStream", str(budget)]) == 0
    assert os.path.isdir(prefix + "0.tpupack.npz.pack5") == streams


@pytest.mark.parametrize("kind", ["col_batch", "col_long"])
def test_streamed_kernel_groups_fit_the_temp_cap(lowered, kind):
    """Every col tile group of a streamed pass keeps its temporaries within
    the engine's cap (the largest one-tile need, here B3's at L = 128):
    B5's boundary columns (all three tiles a group), and B3's carry in and
    out with its boundary columns (one tile a group, where the resident
    engine takes all three); the results equal the resident engine's."""
    rng = np.random.default_rng(83)
    db, _ = _db(rng, rng.integers(49, 65, size=9000))  # one col bucket of 3 tiles, L = 128
    if kind == "col_batch":
        queries = [rng.integers(0, 20, size=n).astype(np.int8) for n in (24, 9, 17)]
    else:
        queries = [rng.integers(0, 20, size=n).astype(np.int8) for n in (25, 30)]
    resident = SearchEngine(device="cpu", num_top=8)
    resident.set_database(db)
    want = _results(resident.scan_many(queries))
    eng = SearchEngine(device="cpu", num_top=8, max_device_bytes=1, stream_chunk_bytes=1 << 22)
    eng.set_database(db)
    cap = eng._temp_bytes
    assert eng.packed.buckets[0].num_tiles == 3 and eng._chunk_tiles(eng.packed.buckets[0]) == 3
    assert cap == 16 * 128 * 4096 + 2 * 4096 * 24 * 4
    groups = []
    if kind == "col_batch":
        real, name = sw_col.score_bucket_col_flat, "score_bucket_col_flat"

        def spy(tiles, qs, m, p, offs, rtot=None):
            groups.append(tiles.shape[0] * 2 * 4096 * rtot * 4)
            return real(tiles, qs, m, p, offs, rtot=rtot)
    else:
        real, name = sw_col.score_bucket_col, "score_bucket_col"

        def spy(tiles, q, m, p, **kw):
            groups.append(tiles.shape[0] * (16 * tiles.shape[1] * 4096 + 2 * 4096 * int(p[0]) * 4))
            return real(tiles, q, m, p, **kw)

    spy.__dict__.update(real.__dict__)  # the wrapper counts its calls on its module name
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sw_col, name, spy)
        got = _results(eng.scan_batch(queries))
    assert got == want
    assert groups and max(groups) <= cap
    # col_batch: a pass a slot (each reserves FLAT_QUANT rows), a group a
    # pass; col_long: a group a tile for each of two NQC chunks of two queries.
    assert len(groups) == (3 if kind == "col_batch" else 3 * 2 * 2)


@pytest.mark.parametrize("shape", [(3, 16, 4, 8), (2, 7, 5), (1, 6), (4, 1), (2, 48, 32, 128)])
def test_codec_words_bit_identical_and_unpack(shape):
    """Both codecs' words equal the JAX package's bit for bit (whose pack
    may run in its native library); the torch unpack equals the numpy one
    and the tiles.  Codes out of a codec's range raise."""
    rng = np.random.default_rng(74)
    for codec, top in (("b32", 26), ("b21", 21)):
        tiles = rng.integers(0, top, size=shape).astype(np.int8)
        words = pack5.CODECS[codec][2](tiles)
        assert words.dtype == np.int32 and (words >= 0).all()
        assert words.shape == (shape[0], pack5.CODECS[codec][1](int(np.prod(shape[1:]))))
        assert np.array_equal(words, jpack5.CODECS[codec][2](tiles))
        back = pack5.CODECS[codec][3](torch.from_numpy(words), tuple(shape[1:]))
        assert back.dtype == torch.int8 and back.is_contiguous()
        assert np.array_equal(back.numpy(), pack5.CODECS[codec][4](words, shape[1:]))
        assert np.array_equal(back.numpy(), tiles)
    out = np.zeros((shape[0], pack5.words_for(int(np.prod(shape[1:])))), np.int32)
    assert pack5.pack5(tiles, out=out, slab=1) is out
    with pytest.raises(ValueError):
        pack5.pack21(np.full((2, 8), 21, np.int8))
    bad = np.full((70, 8), 3, np.int8)
    bad[66, 0] = 32  # past the first slab
    with pytest.raises(ValueError):
        pack5.pack5(bad, slab=64)
    for mode, pad in (("0", 20), ("1", 20), ("2", 20), ("2", 25), ("x", 20), ("", 25)):
        assert pack5.choose_codec(mode, pad) == jpack5.choose_codec(mode, pad)


def _pinned_zip_time(monkeypatch):
    """Hold the time zipfile writes into npz member headers fixed."""
    monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(
        time=lambda: 1_700_000_000.0, localtime=time.localtime))


def _tree(path):
    """{relative name: bytes} of a store: its npz, tiles and sidecar files."""
    out = {}
    for name in (path, path + ".tiles"):
        with open(name, "rb") as f:
            out[os.path.basename(name)] = f.read()
    side = path + ".pack5"
    for name in sorted(os.listdir(side)) if os.path.isdir(side) else []:
        with open(os.path.join(side, name), "rb") as f:
            out["pack5/" + name] = f.read()
    return out


@pytest.mark.parametrize("pad_code", [20, 25])
def test_store_files_byte_identical_and_read_by_both(tmp_path, monkeypatch, lowered, pad_code):
    """pack_db_to_store (with its b32 sidecar) and save_packed write the
    JAX package's files byte for byte; each package loads the other's
    store with the same tiles, and a stale store is refused."""
    _pinned_zip_time(monkeypatch)
    rng = np.random.default_rng(75)
    db, jdb = _three_kinds(rng)
    n, nchars = db.num_sequences, int(db.lengths.sum())
    paths = {k: str(tmp_path / f"{k}.npz") for k in ("t", "j", "ts", "js")}
    tstore = tp.pack_db_to_store(db, paths["t"], pad_code=pad_code, stream_codec="b32")
    jp.pack_db_to_store(jdb, paths["j"], pad_code=pad_code, stream_codec="b32")
    assert set(_tree(paths["t"])) == {"t.npz", "t.npz.tiles", "pack5/b0.bin", "pack5/b1.bin",
                                      "pack5/b2.bin", "pack5/manifest.json"}
    assert list(_tree(paths["t"]).values()) == list(_tree(paths["j"]).values())
    tp.save_packed(tp.pack_db(db, pad_code=pad_code), paths["ts"], pad_code=pad_code)
    jp.save_packed(jp.pack_db(jdb, pad_code=pad_code), paths["js"], pad_code=pad_code)
    assert list(_tree(paths["ts"]).values()) == list(_tree(paths["js"]).values())
    from_jax = tp.load_packed(paths["j"], n, nchars, expect_pad=pad_code)
    from_port = jp.load_packed(paths["t"], n, nchars, expect_pad=pad_code)
    for a, b, c in zip(tstore.buckets, from_jax.buckets, from_port.buckets):
        assert isinstance(b.tiles, np.memmap) and not b.tiles.flags.writeable
        assert np.array_equal(a.tiles, b.tiles) and np.array_equal(a.tiles, c.tiles)
        assert np.array_equal(a.seq_index, c.seq_index) and a.kernel == c.kernel
        seqs, jseqs = tp.unpack_tile_sequences(a, 0), jp.unpack_tile_sequences(c, 0)
        assert len(seqs) == len(jseqs) and all(map(np.array_equal, seqs, jseqs))
    assert tp.load_packed(paths["t"], n + 1, nchars, expect_pad=pad_code) is None
    assert tp.load_packed(paths["t"], n, nchars, expect_pad=pad_code + 1) is None
    assert tp.load_packed(str(tmp_path / "none.npz"), n, nchars) is None
    # Tile ranges (per-host stores, tests/test_torch_host_ranges.py): a
    # complete store covers any, and a build asking for some of its tiles
    # takes it as it is.
    assert tp.load_packed(paths["t"], n, nchars, expect_pad=pad_code,
                          need_ranges=[[(0, 1)]] * 3).tile_ranges is None
    assert tp.pack_db_to_store(db, paths["t"], pad_code=pad_code,
                               tile_ranges=[[(0, 1)]] * 3).tile_ranges is None
    assert list(_tree(paths["t"]).values()) == list(_tree(paths["j"]).values())


def _small_db(tmp_path):
    rng = np.random.default_rng(76)
    return _db(rng, rng.integers(5, 90, size=40))[0]


def test_sidecar_reused_then_stale_on_a_change(tmp_path):
    """The engine's sidecar is reused read-only by a second engine, and a
    database of other residues (one length less) repacks it."""
    db = _small_db(tmp_path)
    cache = str(tmp_path / "cache.npz")
    q = np.random.default_rng(77).integers(0, 20, size=20).astype(np.int8)
    eng = SearchEngine(device="cpu", num_top=5, max_device_bytes=1)
    eng.set_database(db, pack_cache=cache)
    want = _results([eng.scan(q)])
    assert os.path.exists(os.path.join(cache + ".pack5", "manifest.json"))
    eng2 = SearchEngine(device="cpu", num_top=5, max_device_bytes=1)
    eng2.set_database(db, pack_cache=cache)
    mm = eng2._stream_pack[0]
    assert isinstance(mm, np.memmap) and mm.mode == "r"
    assert isinstance(eng2.packed.buckets[0].tiles, np.memmap)
    assert _results([eng2.scan(q)]) == want
    lengths = np.array(db.lengths).copy()
    i = next(i for i in range(1, len(lengths)) if lengths[i] - 1 >= lengths[i - 1] and lengths[i] > 5)
    lengths[i] -= 1
    db2 = DBData(**{f: getattr(db, f) for f in FIELDS if f != "lengths"}, lengths=lengths)
    fresh = SearchEngine(device="cpu", num_top=5, max_device_bytes=1)
    fresh.set_database(db2, pack_cache=str(tmp_path / "cache2.npz"))
    stale = SearchEngine(device="cpu", num_top=5, max_device_bytes=1)
    stale.set_database(db2, pack_cache=cache)
    assert _results([stale.scan(q)]) == _results([fresh.scan(q)])


def test_sidecar_falls_back_when_unwritable(tmp_path):
    """A cache path under a file (no directory can be made there, whoever
    runs the test) packs in RAM and streams from temp files instead of
    failing set_database."""
    db = _small_db(tmp_path)
    blocker = tmp_path / "not_a_dir"
    blocker.write_bytes(b"")
    eng = SearchEngine(device="cpu", num_top=5, max_device_bytes=1)
    eng.set_database(db, pack_cache=str(blocker / "cache.npz"))
    assert eng.streaming and eng._stream_pack is not None
    assert not isinstance(eng.packed.buckets[0].tiles, np.memmap)
    q = np.random.default_rng(78).integers(0, 20, size=20).astype(np.int8)
    ref = SearchEngine(device="cpu", num_top=5)
    ref.set_database(db)
    assert _results([eng.scan(q)]) == _results([ref.scan(q)])


def _tsv_lines(stdout):
    return "".join(line + "\n" for line in stdout.splitlines()
                   if line and (line[0].isdigit() or line.startswith("Query number")))


@pytest.mark.parametrize("mat,golden", [("blosum62", "golden_top10.tsv"),
                                        ("blosum62_full", "golden_top10_full.tsv")])
def test_align_streaming_reproduces_golden_tsv(tmp_path, capsys, mat, golden):
    """align --maxGpuMem 1K streams the golden database (b32 words from
    the sidecar next to the db) and writes the golden TSV byte for byte,
    on a first run that builds the store and a second that loads it."""
    prefix = str(tmp_path / "gdb")
    assert makedb.run([os.path.join(FIXDIR, "golden_db.fa"), prefix]) == 0
    with open(os.path.join(FIXDIR, golden)) as f:
        want = f.read()
    for _ in range(2):
        capsys.readouterr()
        assert align.run(["--query", os.path.join(FIXDIR, "golden_queries.fa"), "--db", prefix,
                          "--top", "10", "--tsv", "--mat", mat, "--device", "cpu",
                          "--maxGpuMem", "1K", "--maxBatchBytes", "4K",
                          "--maxBatchSequences", "128"]) == 0
        assert _tsv_lines(capsys.readouterr().out) == want
        assert os.path.exists(prefix + "0.tpupack.npz.pack5/manifest.json")


def test_makedb_prepack_equals_jax(tmp_path, capsys, monkeypatch):
    """makedb --prepack builds the store and --prepackStream the sidecar,
    byte for byte the JAX makedb's; align then loads them."""
    _pinned_zip_time(monkeypatch)
    fa = os.path.join(FIXDIR, "golden_db.fa")
    for mk, name in ((makedb, "t"), (jax_makedb, "j")):
        assert mk.run([fa, str(tmp_path / name), "--prepack"]) == 0
        assert "TIMING: tile store:" in capsys.readouterr().out
    t, j = (str(tmp_path / n) + "0.tpupack.npz" for n in "tj")
    assert not os.path.exists(t + ".pack5")
    assert list(_tree(t).values()) == list(_tree(j).values())
    for mk, name in ((makedb, "t"), (jax_makedb, "j")):
        assert mk.run([fa, str(tmp_path / name), "--prepackStream", "1K"]) == 0
        assert "TIMING: tile store + transfer sidecar:" in capsys.readouterr().out
    assert list(_tree(t).values()) == list(_tree(j).values())
    assert makedb.run([fa, str(tmp_path / "t"), "--prepackStream"]) == 1
