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
    (test_sw_torch_equals_sw_jax) and the row kernel on the card.  A
    bucket of 128 lanes at L = 32, and one of 256 lanes past the largest
    cell instance (L = 800: the card's col route)."""
    rng = np.random.default_rng(22)
    cfg = jax_scoring("blosum62")
    pad = cfg.pad_code
    for shape, nq in (((1, 32, 128), 30), ((2, 800, 256), 21)):
        tiles = _tiles(rng, shape, pad, shape[0] * shape[2] - 7)
        codes = rng.integers(0, 25 if pad == 25 else 20, size=nq)
        q, n = sw_row.prepare_query(codes, qcap=128, pad=pad)
        jq, jnq = prepare_query(codes, qcap=128, pad=pad)
        assert np.array_equal(q, jq) and n == jnq == nq
        params = np.array([nq, cfg.gop, cfg.gex, -(-nq // 8) * 8], np.int32)
        want = score_bucket_pallas(
            jnp.asarray(tiles), jnp.asarray(q), jnp.asarray(_mat(cfg)), jnp.asarray(params),
            interpret=True,
        )
        got = sw_row.score_bucket_row(
            torch.as_tensor(tiles), torch.as_tensor(q), torch.as_tensor(_mat(cfg)), params
        )
        assert np.array_equal(got.numpy(), np.asarray(want)), shape


def test_row_route_cell_then_col_with_pool_groups():
    """The row kernel's route: the cell group routine at cell_shape(L) up
    to the largest instance (768), with no scratch; past it the col
    wavefront, its int32 boundary columns [tiles x NS, nrows] x 2 sized
    per tile group within the budget (at least one tile a group)."""
    for L in (1, 16, 37, 48, 256, 577, 640, 768):
        assert sw_row.row_route(11, L, 128, 464) == ("cell", sw_cell.cell_shape(L), 11, 0)
    per_tile = 2 * 128 * 464 * 4
    for L in (769, 784, 1100, 2304):
        assert sw_row.row_route(11, L, 128, 464) == ("col", None, 11, 11 * per_tile)
    assert sw_row.row_route(11, 2304, 128, 464, budget=3 * per_tile + 5) == (
        "col", None, 3, 3 * per_tile)
    assert sw_row.row_route(4, 784, 256, 8192, budget=1) == ("col", None, 1, 2 * 256 * 8192 * 4)
    assert sw_row.row_route(3, 900, 256, 0) == ("col", None, 3, 0)
    big = 2 * 128 * 16384 * 4  # a 16,384-row query: 64 tiles in the default budget
    assert sw_row.row_route(100, 1100, 128, 16384)[2:] == (64, 64 * big)


def test_row_wrapper_launches_a_group_at_a_time(monkeypatch):
    """On a device tensor (here "meta", so that no kernel runs) the row
    wrapper launches the cell route once without a pool, and the col route
    once per tile group with one."""
    from cudasw4_tpu_torch.ops import cuda_lib

    calls = []

    def fake(wrapper, tiles, query, matrix_flat, nrows, gop, gex, pool):
        calls.append((tuple(tiles.shape), nrows, gop, gex, pool))
        return torch.zeros((tiles.shape[0], tiles.shape[2]))

    monkeypatch.setattr(cuda_lib, "launch_row", fake)
    q = torch.empty(512, dtype=torch.int32, device="meta")
    m = torch.empty(441, dtype=torch.int32, device="meta")
    t = torch.empty((5, 48, 128), dtype=torch.int8, device="meta")
    assert sw_row.score_bucket_row(t, q, m, (464, -11, -1, 464)).shape == (5, 128)
    assert calls == [((5, 48, 128), 464, -11, -1, False)]
    calls.clear()
    t = torch.empty((5, 2304, 128), dtype=torch.int8, device="meta")
    got = sw_row.score_bucket_row(t, q, m, (464, -11, -1, 464), temp_bytes=2 * 2 * 128 * 464 * 4)
    assert got.shape == (5, 128)
    assert calls == [((2, 2304, 128), 464, -11, -1, True), ((2, 2304, 128), 464, -11, -1, True),
                     ((1, 2304, 128), 464, -11, -1, True)]


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


def test_col_group_tiles_counts_boundary_columns(col_geometry):
    """The tile-group plan of score_bucket_col_any_query counts the col
    kernel's boundary columns (H and E per subject and query row, int32,
    int16 under int16 state) beside the carry: a budget of two tiles'
    carry alone gives one-tile groups.  With it the scores still equal the
    JAX package's, whose budget counts the carry alone (one group of two
    tiles)."""
    T, L, rows = 2, 32, 24
    carry, cols = 8 * L * 4096, 8 * 4096 * rows
    assert sw_col.col_group_tiles(T, L, rows, 1, 1) == T
    assert sw_col.col_group_tiles(T, L, rows, 2, 1) == 1
    assert sw_col.col_group_tiles(T, L, rows, 2, 2 * carry) == 1
    assert sw_col.col_group_tiles(T, L, rows, 2, 2 * (carry + cols)) == 2
    assert sw_col.col_group_tiles(T, L, rows, 2, 2 * carry + cols, exact=False) == 2
    assert sw_col.col_group_tiles(T, L, rows, 2, 2 * carry + cols) == 1

    rng = np.random.default_rng(27)
    cfg = jax_scoring("blosum62_full")
    tiles = _tiles(rng, (T, L, 32, 128), 25, T * 4096 - 9)
    codes = rng.integers(0, 25, size=41).astype(np.int8)
    m = _mat(cfg)
    want = sw_pallas_col.score_bucket_col_any_query(
        jnp.asarray(tiles), codes, jnp.asarray(m), cfg.gop, cfg.gex,
        unroll=8, interpret=True, exact=True, pad=25, temp_bytes=2 * carry,
    )
    got = sw_col.score_bucket_col_any_query(
        torch.as_tensor(tiles), codes, torch.as_tensor(m), cfg.gop, cfg.gex,
        unroll=8, pad=25, temp_bytes=2 * carry,
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


def test_cell_shape_table_covers_every_cell_length():
    """``sw_cell.cell_shape`` gives every multiple of 16 up to CELL_MAX_L
    (the 16-step edges, which hold the default ladder's cell lengths) a
    listed (G, R) instance with G dividing 32 and G x R >= L: the default
    ladder's lengths exactly, the others exactly up to 576 and at most 16
    columns short past it; every instance serves one of them.  Any other
    L up to 768 wastes fewer than 16 columns (32 past 576), and tiles past
    768 get none (they take the col wavefront's passes)."""
    from cudasw4_tpu_torch.db.packing import CELL_MAX_L, DEFAULT_BUCKET_EDGES

    assert len(set(sw_cell.CELL_SHAPES)) == len(sw_cell.CELL_SHAPES)
    used = set()
    for L in range(16, CELL_MAX_L + 1, 16):
        g, r = sw_cell.cell_shape(L)
        used.add((g, r))
        assert (g, r) in sw_cell.CELL_SHAPES and 32 % g == 0 and g * r >= L
        assert g * r - L <= (16 if L > 576 else 0)
        if L in DEFAULT_BUCKET_EDGES:
            assert g * r == L
    assert used == set(sw_cell.CELL_SHAPES)
    for L in range(1, CELL_MAX_L + 1):
        g, r = sw_cell.cell_shape(L)
        assert 0 <= g * r - L < (32 if L > 576 else 16)
    assert sw_cell.cell_shape(CELL_MAX_L) == (32, 24)
    assert sw_cell.cell_shape(CELL_MAX_L + 1) is None


# ------------------------------------------- the col kernels' subject lengths


def _col_db(n=8500, seed=5):
    """DBData of ``n`` uniform-residue entries of 49..200 aa, sorted: with
    CELL_MAX_L lowered to 48, three col tiles in two buckets."""
    from cudasw4_tpu_torch.db.format import DBData

    rng = np.random.default_rng(seed)
    lens = np.sort(rng.integers(49, 201, size=n)).astype(np.int32)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum((lens + 3) // 4 * 4, out=offsets[1:])
    chars = np.full(int(offsets[-1]), 20, np.int8)
    for a, k in zip(offsets[:-1], lens):
        chars[a : a + k] = rng.integers(0, 20, size=int(k))
    return DBData(chars=chars, offsets=offsets.astype(np.uint64), lengths=lens,
                  headers=np.zeros(0, np.uint8), header_offsets=np.zeros(n + 1, np.uint64))


@pytest.fixture
def col_db(monkeypatch):
    import cudasw4_tpu_torch.db.packing as tp

    monkeypatch.setattr(tp, "CELL_MAX_L", 48)
    return _col_db()


def _spy_col_wrappers(monkeypatch):
    """Replace the three col wrappers by spies that record (tiles, lengths,
    exact) of every call and call the wrapper; returns the record."""
    calls = []
    for name in ("score_bucket_col", "score_bucket_col_flat", "score_bucket_col_flat_fused"):
        real = getattr(sw_col, name)

        def spy(tiles, *args, real=real, **kw):
            calls.append((tiles, kw.get("lengths"), kw.get("exact", True)))
            return real(tiles, *args, **kw)

        spy.__dict__.update(real.__dict__)  # the wrapper counts on its module name
        monkeypatch.setattr(sw_col, name, spy)
    return calls


def _assert_own_lengths(packed, calls):
    """Each recorded call took the lengths of exactly the tiles it scored
    (a tile known by its codes), and their per-tile passes."""
    held = {b.tiles[t].tobytes(): b.lengths[t] for b in packed.buckets if b.kernel == "col"
            for t in range(b.num_tiles)}
    assert calls
    for tiles, lengths, _ in calls:
        assert lengths is not None and len(lengths.passes) == tiles.shape[0]
        for k in range(tiles.shape[0]):
            want = held[tiles[k].contiguous().numpy().tobytes()]
            assert np.array_equal(lengths.dev[k].numpy(), want)
            assert lengths.passes[k] == (-(-want.astype(np.int64) // sw_col.COL_PASS)).sum()


@pytest.mark.parametrize("path", ["single", "chunked", "batch", "mesh", "overflow",
                                  "mesh_overflow", "streamed", "streamed_mesh"])
def test_every_col_launch_takes_its_tiles_lengths(monkeypatch, col_db, path):
    """Every call of a col wrapper that the engine makes passes the subject
    lengths of exactly the tiles it scores: a resident single scan, a query
    past NQC in one-tile groups (the carry), a B5 batch, two mesh shards,
    the overflow re-score's ``index_select`` (one flagged tile of a
    bucket's two, on one device and on the mesh), and streamed chunks (one
    tile each, the first resident) on one device and on two shards.  The
    results equal those of an engine whose col launches take no lengths."""
    from cudasw4_tpu_torch.engine_streaming import stream_work_bytes
    from cudasw4_tpu_torch.parallel import sharding

    monkeypatch.setattr(sw_col, "NQC", 24)
    rng = np.random.default_rng(9)
    kw = dict(device="cpu", num_top=5)
    if "mesh" in path:
        kw = dict(mesh=sharding.make_mesh(["cpu"] * 2), num_top=5)
    if path == "chunked":
        kw["col_temp_bytes"] = 1
    if path.startswith("streamed"):
        kw["stream_chunk_bytes"] = 128 * 4096
        work = stream_work_bytes([(128, 4096, "col", 2), (256, 4096, "col", 1)], 128 * 4096)[0]
        kw["max_device_bytes"] = 1 if "mesh" in path else work + 4096 * 132
    queries = [rng.integers(0, 20, size=n).astype(np.int8) for n in (20, 9, 17)]
    if path == "chunked":
        queries = [rng.integers(0, 20, size=60).astype(np.int8)]
    if path.endswith("overflow"):
        monkeypatch.setattr(sw_cell, "SAT", 150)
        queries = [col_db.get_sequence(4000)]  # its own hit passes SAT; no other does
    plain = SearchEngine(**kw)
    plain.set_database(col_db)
    eng = SearchEngine(**kw)
    eng.state16 = path.endswith("overflow")
    eng.set_database(col_db)
    assert [(b.L, b.num_tiles) for b in eng.packed.buckets if b.kernel == "col"] == [(128, 2), (256, 1)]
    if path == "streamed":
        assert eng.streaming and [bi for bi, *_ in eng._resident_chunks] == [0]
    if path == "streamed_mesh":
        assert eng.streaming and not eng._resident_chunks
    # The reference: the same engine with its col lengths dropped.
    plain.state16 = eng.state16
    plain._bucket_lengths = [None] * len(plain._bucket_lengths)
    for sh in plain._shards:
        sh.lengths = [None] * len(sh.lengths)
    want = [(r.scores, r.reference_ids) for r in plain.scan_many(queries)]
    calls = _spy_col_wrappers(monkeypatch)
    if path == "batch":
        got = eng.scan_batch(queries)
    else:
        got = list(eng.scan_many(queries))
    assert [(r.scores, r.reference_ids) for r in got] == want
    _assert_own_lengths(eng.packed, calls)
    if path.endswith("overflow"):  # the fast pass in int16 state, the re-score exact
        assert got[0].stats.num_overflows >= 1
        assert {t.shape[0] for t, _, exact in calls if exact} == {1}


def test_col_pass_counters_equal_the_plan(monkeypatch, col_db):
    """On the card's branch (tiles, lengths and queries on "meta" tensors,
    ``launch_col`` patched to zero scores), a single scan and a batch of
    three count on the col wrappers the passes that ``plan_buckets`` gives
    the database's col buckets, with COL_PASS lowered to 32 so that every
    subject spans passes: ``col_warp_passes`` the sum of each subject's
    ceil(len / COL_PASS), ``col_bucket_passes`` T x 4096 x ceil(L /
    COL_PASS) a bucket, each once a query; every launch takes its tiles'
    lengths."""
    from cudasw4_tpu_torch.db.packing import plan_buckets
    from cudasw4_tpu_torch.ops import cuda_lib

    monkeypatch.setattr(sw_col, "COL_PASS", 32)
    monkeypatch.setattr(sw_col, "NQC", 24)
    eng = SearchEngine(device="cpu", num_top=5)
    eng.set_database(col_db)
    lengths = np.asarray(col_db.lengths, np.int64)
    warp = full = 0
    for start, stop, L, NS, kernel in plan_buckets(lengths):
        assert kernel == "col"
        warp += int((-(-lengths[start:stop] // 32)).sum())
        full += -(-(stop - start) // NS) * NS * -(-L // 32)
    assert warp < full

    def fake(wrapper, kernel, tiles, queries, *args, lengths=None, **kw):
        assert lengths is not None and lengths.shape == (tiles.shape[0], 4096)
        return torch.zeros((queries.shape[0], tiles.shape[0], 4096)), None

    monkeypatch.setattr(cuda_lib, "launch_col", fake)
    monkeypatch.setattr(cuda_lib, "to_device", lambda a, dev: torch.as_tensor(a).to("meta"))
    monkeypatch.setattr(eng, "_bucket_tiles", [t.to("meta") for t in eng._bucket_tiles])
    monkeypatch.setattr(eng, "_bucket_lengths", [sw_col.ColLengths(c.dev.to("meta"), c.passes)
                                                 for c in eng._bucket_lengths])
    monkeypatch.setattr(eng, "_matrix_flat", eng._matrix_flat.to("meta"))
    wrappers = (sw_col.score_bucket_col, sw_col.score_bucket_col_flat,
                sw_col.score_bucket_col_flat_fused)

    def counts():
        return [sum(getattr(w, name) for w in wrappers)
                for name in ("col_warp_passes", "col_bucket_passes")]

    rng = np.random.default_rng(12)
    before = counts()
    eng.scan(rng.integers(0, 20, size=20).astype(np.int8))
    assert counts() == [before[0] + warp, before[1] + full]
    before = counts()
    eng.scan_batch([rng.integers(0, 20, size=n).astype(np.int8) for n in (20, 9, 17)])
    assert counts() == [before[0] + 3 * warp, before[1] + 3 * full]
