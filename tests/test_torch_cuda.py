"""CUDA kernels of cudasw4_tpu_torch against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and skips without one.  Tolerance:
exact — scores and carried DP state are integers.  The file imports no
JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from cudasw4_tpu_torch import make_scoring_config
from cudasw4_tpu_torch.db.packing import PackedBucket, PackedDB
from cudasw4_tpu_torch.engine import SearchEngine
from cudasw4_tpu_torch.ops import cuda_lib, sw_cell, sw_col, sw_row
from cudasw4_tpu_torch.ops.oracle import sw_score_scalar

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _tiles(rng, shape, pad, nreal, A):
    """Random subject codes in [0, A-1) with ragged real lengths; positions
    past each subject's length and lanes past ``nreal`` carry ``pad``."""
    T, L = shape[0], shape[1]
    ns = int(np.prod(shape[2:]))
    x = rng.integers(0, A - 1, size=(T, L, ns)).astype(np.int8)
    lens = rng.integers(1, L + 1, size=(T, ns))
    x[np.arange(L)[None, :, None] >= lens[:, None, :]] = pad
    flat = x.transpose(0, 2, 1).reshape(T * ns, L)
    flat[nreal:] = pad
    x = flat.reshape(T, ns, L).transpose(0, 2, 1)
    return np.ascontiguousarray(x).reshape(shape)


def _query(rng, nq, cap, pad, A):
    q = np.full(cap, pad, np.int32)
    q[:nq] = rng.integers(0, A - 1, size=nq)
    return q


MATS = ["blosum62", "blosum62_full"]


@pytest.mark.parametrize("mat", MATS)
def test_cell_kernel_equals_plain(dev, mat):
    rng = np.random.default_rng(11)
    cfg = make_scoring_config(mat)
    A, pad = cfg.alphabet_size, cfg.pad_code
    tiles = _tiles(rng, (2, 64, 32, 128), pad, 2 * 4096 - 100, A)
    q = _query(rng, 53, 256, pad, A)
    m = torch.as_tensor(cfg.matrix.astype(np.int32).reshape(-1))
    params = (53, cfg.gop, cfg.gex, 56)
    want = sw_cell.score_bucket_cell_plain(torch.as_tensor(tiles), torch.as_tensor(q), m, params)
    before = sw_cell.score_bucket_cell.launches
    got = sw_cell.score_bucket_cell(
        torch.as_tensor(tiles).to(dev), torch.as_tensor(q).to(dev), m.to(dev), params
    )
    assert sw_cell.score_bucket_cell.launches == before + 1
    assert torch.equal(got.cpu(), want)


def _edge_lanes(tiles, pad, rng):
    """In place on int8 [T, L, 32, 128] tiles: lanes 0-5 of tile 0 hold
    subjects of L, L - 1, 1, L, 1 and L - 1 residues (both halves of the
    int16 kernel's subject pairs), the last 100 lanes are empty."""
    x = tiles.view(tiles.shape[0], tiles.shape[1], 4096)
    L = x.shape[1]
    for lane, n in enumerate((L, L - 1, 1, L, 1, L - 1)):
        x[0, :, lane] = torch.as_tensor(rng.integers(0, pad, size=L).astype(np.int8))
        x[0, max(n, 0):, lane] = pad
    x[-1, :, -100:] = pad


#: Cell lengths: the default ladder's cell buckets and a sample of the
#: 16-step edges (G x R = L, or 16 more past 576: 752), lengths that are
#: no multiple of 16 (G x R > L), and one past the largest instance (896:
#: the col wavefront's passes).
CELL_LS = [64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 384, 448, 512, 640, 768,
           16, 48, 144, 208, 272, 304, 400, 752, 37, 300, 896]


@pytest.mark.parametrize("L", CELL_LS)
def test_cell_kernels_equal_plain_at_every_shape(dev, monkeypatch, L):
    """B1 at nq = 1, 7, 8, 9 and 464 equal to the plain version, and B1
    int16 under the SAT rule against the plain int16 and exact scores at
    the default SAT and a lowered one, on subjects of L, L - 1 and 1
    residues and empty lanes; the alphabets alternate by case.  The plain
    version runs on the card."""
    k = CELL_LS.index(L)
    rng = np.random.default_rng(40 + k)
    cfg = make_scoring_config(MATS[k % 2])
    A, pad = cfg.alphabet_size, cfg.pad_code
    T = 2 if L <= 256 else 1
    t = torch.as_tensor(_tiles(rng, (T, L, 32, 128), pad, T * 4096, A))
    _edge_lanes(t, pad, rng)
    t = t.to(dev)
    m = torch.as_tensor(cfg.matrix.astype(np.int32).reshape(-1)).to(dev)
    q = torch.as_tensor(_query(rng, 464, 512, pad, A)).to(dev)
    for nq in (1, 7, 8, 9, 464):
        p = (nq, cfg.gop, cfg.gex, -(-nq // 8) * 8)
        want = sw_cell.score_bucket_cell_plain(t, q, m, p)
        assert torch.equal(sw_cell.score_bucket_cell(t, q, m, p), want), f"nq={nq}"
    p = (464, cfg.gop, cfg.gex, 464)
    for sat in SATS:
        monkeypatch.setattr(sw_cell, "SAT", sat)
        before = sw_cell.score_bucket_cell.launches16
        got = sw_cell.score_bucket_cell(t, q, m, p, exact=False)
        assert sw_cell.score_bucket_cell.launches16 == before + 1
        assert bool(sw_cell.sat_match(got, sw_cell.score_bucket_cell_plain(t, q, m, p, exact=False)).all())
        assert bool(sw_cell.sat_match(got, want).all()), f"SAT={sat} vs exact"


@pytest.mark.parametrize("L", [64, 300, 768])
def test_cell_kernels_long_queries_equal_plain(dev, L):
    """B1 and B1 int16 at nq = 3072 and at a query of QCAP + 9 rows in a
    block of 2 x QCAP; the plain version runs on the card."""
    rng = np.random.default_rng(50 + L)
    cfg = make_scoring_config("blosum62_full" if L == 300 else "blosum62")
    A, pad = cfg.alphabet_size, cfg.pad_code
    t = torch.as_tensor(_tiles(rng, (1, L, 32, 128), pad, 4096 - 50, A))
    _edge_lanes(t, pad, rng)
    t = t.to(dev)
    m = torch.as_tensor(cfg.matrix.astype(np.int32).reshape(-1)).to(dev)
    for nq, cap in ((3072, 3072), (sw_cell.QCAP + 9, 2 * sw_cell.QCAP)):
        q = torch.as_tensor(_query(rng, nq, cap, pad, A)).to(dev)
        p = (nq, cfg.gop, cfg.gex, nq)
        want = sw_cell.score_bucket_cell_plain(t, q, m, p)
        assert torch.equal(sw_cell.score_bucket_cell(t, q, m, p), want), f"nq={nq}"
        got16 = sw_cell.score_bucket_cell(t, q, m, p, exact=False)
        assert bool(sw_cell.sat_match(got16, want).all()), f"int16 nq={nq}"


def test_cell16_unproven_fit_runs_int32(dev):
    """A matrix whose scores could carry an s16x2 lane past 32767
    (blosum62 x 1000 over 9 rows): the int16 kernel runs the int32
    routine, counted as an int16 launch, and its scores meet the SAT rule
    against the exact ones (they are exact)."""
    rng = np.random.default_rng(26)
    cfg = make_scoring_config("blosum62")
    A, pad = cfg.alphabet_size, cfg.pad_code
    tiles = _tiles(rng, (1, 64, 32, 128), pad, 4096 - 9, A)
    qh = _query(rng, 9, 64, pad, A)
    tiles.reshape(64, 4096)[:9, 0] = qh[:9]  # subject 0 holds the query
    t = torch.as_tensor(tiles).to(dev)
    m = torch.as_tensor((cfg.matrix.astype(np.int32) * 1000).reshape(-1)).to(dev)
    q = torch.as_tensor(qh).to(dev)
    p = (9, cfg.gop, cfg.gex, 16)
    want = sw_cell.score_bucket_cell_plain(t, q, m, p)
    assert int(want.max()) > 32767
    before = sw_cell.score_bucket_cell.launches16
    got = sw_cell.score_bucket_cell(t, q, m, p, exact=False)
    assert sw_cell.score_bucket_cell.launches16 == before + 1
    assert torch.equal(got, want)
    assert bool(sw_cell.sat_match(got, want).all())


#: The exact route's cases: every (G, R) instance at its largest L (G x R)
#: with both alphabets, and B1 and B4 with blosum62 x 1000, past
#: ``cell16_bmax`` for every slot of more than two rows (the int32
#: fallback inside sw_cell16_kernel).
EXACT16_CASES = [(g, r, mat) for g, r in sw_cell.CELL_SHAPES for mat in MATS] + [
    (8, 8, "x1000"), (32, 24, "x1000")]


@pytest.mark.parametrize("g,r,mat", EXACT16_CASES)
def test_exact_cell_launches_in_s16x2_lanes_equal_int32(dev, g, r, mat):
    """Exact B1 and B4 on the s16x2 route (``sw_cell16_kernel``) equal the
    plain version's int32 scores bit for bit, at L = G x R on
    subjects of L, L - 1 and 1 residues, B4 on slots of unequal rows (one
    empty); each launch
    counts in ``launches``, not ``launches16``, and its slots by lanes as
    the route and the host's fit (``cuda_lib.cell16_fits``) say."""
    rng = np.random.default_rng(1000 + 10 * g + r)
    cfg = make_scoring_config("blosum62" if mat == "x1000" else mat)
    A, pad, L = cfg.alphabet_size, cfg.pad_code, g * r
    scale = 1000 if mat == "x1000" else 1
    t = torch.as_tensor(_tiles(rng, (1, L, 32, 128), pad, 4096 - 30, A))
    _edge_lanes(t, pad, rng)
    rows = (100, 0, 1, 37, 9)
    qh = np.full((len(rows), 128), pad, np.int32)
    for s, n in enumerate(rows):
        qh[s, :n] = rng.integers(0, A - 1, size=n)
    k = min(L, 100)
    t.view(L, 4096)[:k, 7] = torch.as_tensor(qh[0, :k].astype(np.int8))  # subject 7: the query
    t, q = t.to(dev), torch.as_tensor(qh).to(dev)
    m = cuda_lib.device_matrix(cfg.matrix * scale, dev)
    lo, hi = m.score_range
    for name, fn, args, slots in (
        ("B1", sw_cell.score_bucket_cell, (t, q[0], m, (100, cfg.gop, cfg.gex, 104)), [100]),
        ("B4", sw_cell.score_bucket_cell_batch, (t, q, m, (0, cfg.gop, cfg.gex, 0, *rows)),
         [n for n in rows if n > 0]),
    ):
        want = (sw_cell.score_bucket_cell_plain if name == "B1"
                else sw_cell.score_bucket_cell_batch_plain)(*args)
        before = (fn.launches, fn.launches16, fn.s16x2_slots, fn.int32_slots)
        got = fn(*args)
        fits = [cuda_lib.cell16_fits(L, n, cfg.gop, cfg.gex, lo, hi) for n in slots]
        assert fits == [scale == 1 or n <= 2 for n in slots], name
        n16 = sum(fits)
        assert (fn.launches, fn.launches16, fn.s16x2_slots, fn.int32_slots) == (
            before[0] + 1, before[1], before[2] + n16, before[3] + len(slots) - n16), name
        torch.cuda.synchronize()
        assert torch.equal(got, want), name
    if scale > 1:
        assert int(want.max()) > 32767  # past s16x2 lanes' range: the fallback ran


def test_cell_shape_table_matches_the_library(dev):
    """The instances built into the kernel library are sw_cell.CELL_SHAPES."""
    assert cuda_lib.cell_shapes() == list(sw_cell.CELL_SHAPES)


@pytest.mark.parametrize("mat", MATS)
@pytest.mark.parametrize("L,NS", [(37, 128), (40, 256)])
def test_row_kernel_equals_plain(dev, mat, L, NS):
    rng = np.random.default_rng(12)
    cfg = make_scoring_config(mat)
    A, pad = cfg.alphabet_size, cfg.pad_code
    tiles = _tiles(rng, (3, L, NS), pad, 3 * NS - 5, A)
    q = _query(rng, 29, 64, pad, A)
    m = torch.as_tensor(cfg.matrix.astype(np.int32).reshape(-1))
    params = (29, cfg.gop, cfg.gex, 32)
    want = sw_row.score_bucket_row_plain(torch.as_tensor(tiles), torch.as_tensor(q), m, params)
    got = sw_row.score_bucket_row(
        torch.as_tensor(tiles).to(dev), torch.as_tensor(q).to(dev), m.to(dev), params
    )
    assert torch.equal(got.cpu(), want)


#: B2's lengths: both sides of the cell route's end (768; 784, one 16-step
#: past it), L no multiple of 16 on each route, a partial last col pass
#: (1100) and full ones (2304).
ROW_LS = [37, 48, 768, 784, 1100, 2304]


def _row_inputs(rng, shape, mat):
    """Row tiles with ragged subjects, lanes 0-2 of tile 0 of L, L - 1 and
    1 residues and the last 5 lanes empty; the matrix and the config."""
    cfg = make_scoring_config(mat)
    A, pad = cfg.alphabet_size, cfg.pad_code
    T, L, NS = shape
    x = _tiles(rng, shape, pad, T * NS - 5, A)
    for lane, n in enumerate((L, L - 1, 1)):
        x[0, :, lane] = rng.integers(0, A - 1, size=L)
        x[0, n:, lane] = pad
    m = torch.as_tensor(cfg.matrix.astype(np.int32).reshape(-1))
    return torch.as_tensor(x), m, cfg


@pytest.mark.parametrize("NS", [128, 256])
@pytest.mark.parametrize("L", ROW_LS)
def test_row_kernel_routes_equal_plain(dev, L, NS):
    """B2 on its cell route (L <= 768, at cell_shape(L)) and its col route,
    at nq = 1, 29 and 464, against the plain version on the card; one
    launch a call.  The alphabets alternate by case."""
    k = ROW_LS.index(L) + (NS == 256)
    rng = np.random.default_rng(60 + k)
    t, m, cfg = _row_inputs(rng, (3, L, NS), MATS[k % 2])
    A, pad = cfg.alphabet_size, cfg.pad_code
    t, m = t.to(dev), m.to(dev)
    q = torch.as_tensor(_query(rng, 464, 512, pad, A)).to(dev)
    assert sw_row.row_route(3, L, NS, 464)[0] == ("cell" if L <= 768 else "col")
    for nq in (1, 29, 464):
        p = (nq, cfg.gop, cfg.gex, -(-nq // 8) * 8)
        want = sw_row.score_bucket_row_plain(t, q, m, p)
        before = sw_row.score_bucket_row.launches
        got = sw_row.score_bucket_row(t, q, m, p)
        assert sw_row.score_bucket_row.launches == before + 1
        assert torch.equal(got, want), f"nq={nq}"


@pytest.mark.parametrize("L,NS,nq,groups", [(1100, 128, 3100, 3), (784, 30, 464, 2),
                                            (48, 30, 464, 1), (784, 100, 0, 1)])
def test_row_kernel_long_queries_odd_widths_and_groups(dev, L, NS, nq, groups):
    """B2 against the plain version on the card: a query past NQC rows on
    the col route, widths whose T x NS fills no whole block (30 and 100
    lanes), an empty query, and tile groups: a budget of ceil(T / groups)
    tiles' boundary columns gives ``groups`` launches."""
    rng = np.random.default_rng(70 + L + NS)
    T = 3
    t, m, cfg = _row_inputs(rng, (T, L, NS), "blosum62")
    t, m = t.to(dev), m.to(dev)
    q = torch.as_tensor(_query(rng, nq, max(nq, 8), cfg.pad_code, cfg.alphabet_size)).to(dev)
    p = (nq, cfg.gop, cfg.gex, -(-nq // 8) * 8)
    per_tile = cuda_lib.col_boundary_bytes(1, nq, ns=NS)
    budget = max(1, -(-T // groups) * per_tile)
    want = sw_row.score_bucket_row_plain(t, q, m, p)
    before = sw_row.score_bucket_row.launches
    got = sw_row.score_bucket_row(t, q, m, p, temp_bytes=budget)
    assert sw_row.score_bucket_row.launches == before + groups
    assert torch.equal(got, want)


@pytest.mark.parametrize("mat", MATS)
def test_col_kernel_carry_equals_plain(dev, mat):
    """One chunk emitting its state, then a chunk taking it and emitting
    again: scores and the carried H/F rows equal the plain version's."""
    rng = np.random.default_rng(13)
    cfg = make_scoring_config(mat)
    A, pad = cfg.alphabet_size, cfg.pad_code
    tiles = _tiles(rng, (2, 256, 32, 128), pad, 2 * 4096, A)
    m = torch.as_tensor(cfg.matrix.astype(np.int32).reshape(-1))
    t_cpu, t_dev = torch.as_tensor(tiles), torch.as_tensor(tiles).to(dev)
    q1 = _query(rng, 40, 64, pad, A)
    q2 = _query(rng, 21, 64, pad, A)
    p1 = (40, cfg.gop, cfg.gex, 0)
    p2 = (24, cfg.gop, cfg.gex, 0)
    s1w, st1w = sw_col.score_bucket_col_plain(t_cpu, torch.as_tensor(q1), m, p1, emit_state=True)
    s1, st1 = sw_col.score_bucket_col(
        t_dev, torch.as_tensor(q1).to(dev), m.to(dev), p1, emit_state=True
    )
    assert torch.equal(s1.cpu(), s1w)
    assert torch.equal(st1[0].cpu(), st1w[0]) and torch.equal(st1[1].cpu(), st1w[1])
    s2w, st2w = sw_col.score_bucket_col_plain(
        t_cpu, torch.as_tensor(q2), m, p2, state_in=st1w, emit_state=True
    )
    s2, st2 = sw_col.score_bucket_col(
        t_dev, torch.as_tensor(q2).to(dev), m.to(dev), p2,
        state_in=st1, take_init=True, emit_state=True,
    )
    assert torch.equal(s2.cpu(), s2w)
    assert torch.equal(st2[0].cpu(), st2w[0]) and torch.equal(st2[1].cpu(), st2w[1])
    s3 = sw_col.score_bucket_col(
        t_dev, torch.as_tensor(q2).to(dev), m.to(dev), p2, state_in=st1, take_init=True
    )
    assert torch.equal(s3.cpu(), s2w)


#: The col kernel's edges: (tiles shape, real rows of each query chunk).
#: At its pass of 512 columns (cuda_lib.lib().sw_col_pass_columns()), L=128
#: is one partial pass, L=1664 three full passes and a partial one (the
#: carry over two chunks), and chunks of 8 and 3 rows run nq_pad = 8 over
#: two full passes.
COL_EDGES = [
    ((1, 128, 32, 128), (13,)),
    ((1, 1664, 32, 128), (40, 21)),
    ((2, 1024, 32, 128), (8, 3)),
]


@pytest.mark.parametrize("sat", [None, 30])
@pytest.mark.parametrize("case", range(len(COL_EDGES)))
def test_col_kernel_edges_equal_plain(dev, monkeypatch, case, sat):
    """The col wavefront at its edges against the plain version on the
    card, chunk by chunk with the carry: exact state, scores and both
    carried rows equal; int16 state at a lowered SAT, the scores so far
    under the SAT rule and the carried rows equal on subjects below it."""
    if sat is not None:
        monkeypatch.setattr(sw_cell, "SAT", sat)
    shape, lens = COL_EDGES[case]
    rng = np.random.default_rng(30 + case)
    cfg = make_scoring_config("blosum62_full" if case % 2 else "blosum62")
    A, pad = cfg.alphabet_size, cfg.pad_code
    t = torch.as_tensor(_tiles(rng, shape, pad, shape[0] * 4096 - 7, A)).to(dev)
    m = torch.as_tensor(cfg.matrix.astype(np.int32).reshape(-1)).to(dev)
    exact = sat is None
    st = st_w = st_x = best = None
    for k, n in enumerate(lens):
        nq_pad = max(8, -(-n // 8) * 8)
        q = torch.as_tensor(_query(rng, n, nq_pad, pad, A)).to(dev)
        p = (nq_pad, cfg.gop, cfg.gex, 0)
        emit = k + 1 < len(lens)
        kw = {"emit_state": emit, "exact": exact}
        got = sw_col.score_bucket_col(t, q, m, p, state_in=st, take_init=st is not None, **kw)
        want = sw_col.score_bucket_col_plain(t, q, m, p, state_in=st_w, **kw)
        ex = sw_col.score_bucket_col_plain(t, q, m, p, state_in=st_x, emit_state=emit)
        if emit:
            (got, st), (want, st_w), (ex, st_x) = got, want, ex
        step = (got, want, ex)
        best = step if best is None else tuple(map(torch.maximum, best, step))
        if exact:
            assert torch.equal(got, want), f"chunk {k} scores"
            assert not emit or all(torch.equal(a, b) for a, b in zip(st, st_w)), f"chunk {k} carry"
            continue
        assert bool(sw_cell.sat_match(best[0], best[1]).all()), f"chunk {k} vs plain int16"
        assert bool(sw_cell.sat_match(best[0], best[2]).all()), f"chunk {k} vs exact"
        if emit:
            assert all(s.dtype == torch.int32 for s in st)
            assert _sat_lanes_equal(st, [s.cpu() for s in st_w], best[2].cpu(), sat)


def test_col_flat_unequal_slots_equal_plain(dev):
    """B5 on one pass of slots of 8, 1000 and 3072 rows, each in its own
    range of the boundary pool, over two full subject passes and a partial
    one; the plain version runs on the card."""
    from cudasw4_tpu_torch.ops import col_flat_plan

    rng = np.random.default_rng(36)
    lens = (8, 1000, 3072)
    tiles, q, m, cfg = _batch_inputs(rng, "blosum62", (1, 1152, 32, 128), lens, 3072)
    rtot = 128 + 1024 + 3072
    (plan,) = col_flat_plan(lens, rtot=rtot)
    offs = tuple(o for _, o in sorted(plan))
    params = (0, cfg.gop, cfg.gex, 0, *lens)
    t, qd, md = tiles.to(dev), q.to(dev), m.to(dev)
    want = sw_col.score_bucket_col_flat_plain(t, qd, md, params)
    before = sw_col.score_bucket_col_flat.launches
    got = sw_col.score_bucket_col_flat(t, qd, md, params, offs, rtot=rtot)
    torch.cuda.synchronize()
    assert sw_col.score_bucket_col_flat.launches == before + 1
    assert torch.equal(got, want)


def test_col_any_query_tile_groups_match_oracle(dev, monkeypatch):
    """A query of three NQC chunks, one-tile groups, against the scalar
    oracle on a sample of subjects."""
    monkeypatch.setattr(sw_col, "NQC", 32)
    rng = np.random.default_rng(14)
    cfg = make_scoring_config("blosum62")
    A, pad = cfg.alphabet_size, cfg.pad_code
    tiles = _tiles(rng, (2, 128, 32, 128), pad, 2 * 4096, A)
    codes = rng.integers(0, 20, size=77).astype(np.int8)
    m = torch.as_tensor(cfg.matrix.astype(np.int32).reshape(-1))
    got = sw_col.score_bucket_col_any_query(
        torch.as_tensor(tiles).to(dev), codes, m.to(dev), cfg.gop, cfg.gex,
        pad=pad, temp_bytes=1,
    ).cpu().reshape(-1)
    flat = tiles.reshape(2, 128, 4096).transpose(0, 2, 1).reshape(-1, 128)
    for k in rng.choice(len(flat), size=12, replace=False):
        want = sw_score_scalar(codes, flat[k], cfg.matrix, cfg.gop, cfg.gex)
        assert int(got[k]) == want


def _length_lanes(rng, T, L, order):
    """Subject lengths [T, 4096] of col tiles of L columns: the pass edges
    0, 1, 511, 512, 513, L - 1 and L (capped at L) eight lanes each, the
    rest random in [0, L], ascending as a bucket packs them or shuffled."""
    edges = np.minimum([0, 1, 511, 512, 513, L - 1, L], L)
    lens = rng.integers(0, L + 1, size=T * 4096)
    lens[: 8 * len(edges)] = np.repeat(edges, 8)
    lens = np.sort(lens) if order == "ascending" else rng.permutation(lens)
    return lens.reshape(T, 4096).astype(np.int32)


def _length_tiles(rng, lens, L, pad, A):
    """Col tiles holding subjects of ``lens``, the pad code past each."""
    T = lens.shape[0]
    x = rng.integers(0, A - 1, size=(T, L, 4096)).astype(np.int8)
    x[np.arange(L)[None, :, None] >= lens[:, None, :]] = pad
    return torch.as_tensor(x.reshape(T, L, 32, 128))


def _own_passes(lens, L, P):
    """Mask [T, L, 32, 128] of the columns inside each subject's own
    passes of P columns, where the carry out is specified with lengths."""
    ends = -(-lens.astype(np.int64) // P) * P
    own = np.arange(L)[None, :, None] < ends[:, None, :]
    return torch.as_tensor(own.reshape(lens.shape[0], L, 32, 128))


@pytest.mark.parametrize("order", ["ascending", "shuffled"])
@pytest.mark.parametrize("L", [512, 1664])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("kind", ["col", "col_carry", "flat", "fused"])
def test_col_kernels_with_lengths_equal_without(dev, kind, exact, L, order):
    """B3 (alone, and a query past NQC: two chunks with the carry), B5 and
    B6, in exact and int16 state (``sw_col16_kernel``,
    ``sw_col_flat16_kernel``, ``sw_col_fused16_kernel``), on lanes at the
    pass edges: with the tiles' lengths every warp runs only its own passes,
    and the scores equal those without and the plain version's, bit for
    bit; the carry equals the plain version's at every column inside a
    subject's own passes.  The launches count their warp-passes and the
    bucket's."""
    P = sw_col.col_pass(dev)
    rng = np.random.default_rng(41 + L)
    cfg = make_scoring_config("blosum62")
    A, pad = cfg.alphabet_size, cfg.pad_code
    T = 2
    lens = _length_lanes(rng, T, L, order)
    t = _length_tiles(rng, lens, L, pad, A).to(dev)
    m = torch.as_tensor(cfg.matrix.astype(np.int32).reshape(-1)).to(dev)
    cl = sw_col.ColLengths.place(lens, dev)
    passes = int((-(-lens.astype(np.int64) // P)).sum())
    if kind in ("col", "col_carry"):
        fn, S = sw_col.score_bucket_col, 1
        qs = [torch.as_tensor(_query(rng, n, 48, pad, A)).to(dev) for n in (40, 21)]
        ps = [(48, cfg.gop, cfg.gex, 0), (24, cfg.gop, cfg.gex, 0)]
        if kind == "col":
            qs, ps = qs[:1], ps[:1]

        def run(lengths):
            out, st = [], None
            for k, (q, p) in enumerate(zip(qs, ps)):
                res = fn(t, q, m, p, state_in=st, take_init=st is not None,
                         emit_state=k + 1 < len(qs), exact=exact, lengths=lengths)
                s, st = res if k + 1 < len(qs) else (res, None)
                out.append((s, st))
            return out

        def plain():
            out, st = [], None
            for k, (q, p) in enumerate(zip(qs, ps)):
                res = sw_col.score_bucket_col_plain(t, q, m, p, state_in=st,
                                                    emit_state=k + 1 < len(qs), exact=exact)
                s, st = res if k + 1 < len(qs) else (res, None)
                out.append((s, st))
            return out
    else:
        nqps = (8, 0, 40, 16)
        S = len(nqps)
        q = torch.as_tensor(np.stack([_query(rng, max(0, n - 3), 48, pad, A) for n in nqps]))
        params = (0, cfg.gop, cfg.gex, 0, *nqps)
        q = q.to(dev)

        def plain():
            return [(sw_col.score_bucket_col_flat_plain(t, q, m, params, exact), None)]
        if kind == "flat":
            fn = sw_col.score_bucket_col_flat
            offs = tuple(64 * s for s in range(S))

            def run(lengths):
                return [(fn(t, q, m, params, offs, rtot=256, exact=exact, lengths=lengths), None)]
        else:
            fn = sw_col.score_bucket_col_flat_fused

            def run(lengths):
                return [(fn(t, q, m, params, rtot=128, exact=exact, lengths=lengths), None)]
    want = run(None)
    before = (fn.col_warp_passes, fn.col_bucket_passes)
    got = run(cl)
    torch.cuda.synchronize()
    launches = len(got)
    assert (fn.col_warp_passes - before[0], fn.col_bucket_passes - before[1]) == (
        launches * S * passes, launches * S * T * 4096 * -(-L // P))
    own = _own_passes(lens, L, P).to(dev)
    for (g, gs), (w, ws), (r, rs) in zip(got, want, plain()):
        assert torch.equal(g, w) and torch.equal(g, r)
        if gs is not None:  # the carry inside the own passes: without lengths and plain
            for a, b, c in zip(gs, ws, rs):
                assert torch.equal(a[own], b[own]) and torch.equal(a[own], c[own])


def test_engine_cuda_equals_cpu(dev):
    """The engine on the card and on the CPU give the same top hits on a
    database with one bucket of each kind."""
    rng = np.random.default_rng(15)
    cfg = make_scoring_config("blosum62")
    pad = cfg.pad_code
    buckets = []
    base = 0
    for L, kind, ns in ((32, "row", 128), (64, "cell", 4096), (256, "col", 4096)):
        cnt = ns - 3
        tiles = _tiles(rng, (1, L, ns) if kind == "row" else (1, L, 32, 128), pad, cnt, 21)
        sidx = np.full((1, ns), -1, np.int32)
        sidx[0, :cnt] = np.arange(base, base + cnt)
        buckets.append(PackedBucket(L=L, NS=ns, tiles=tiles, seq_index=sidx,
                                    lengths=(sidx >= 0).astype(np.int32) * L, kernel=kind))
        base += cnt
    packed = PackedDB(buckets=buckets, num_sequences=base, total_real_chars=base)
    queries = [rng.integers(0, 20, size=n).astype(np.int8) for n in (17, 120)]
    results = []
    for device in ("cpu", "cuda"):
        eng = SearchEngine(scoring=cfg, num_top=25, device=device)
        eng.set_database(None, packed=packed)
        results.append([(r.scores, r.reference_ids) for r in eng.scan_many(queries)])
    assert results[0] == results[1]


def test_wrapper_rejects_bad_arguments(dev):
    m = torch.zeros(441, dtype=torch.int32, device=dev)
    q = torch.zeros(16, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        sw_row.score_bucket_row(torch.zeros((1, 8, 128), dtype=torch.int32, device=dev), q, m, (4, -11, -1, 8))
    with pytest.raises(ValueError):
        sw_cell.score_bucket_cell(torch.zeros((1, 8, 32, 128), dtype=torch.int8, device=dev), q, m, (17, -11, -1, 24))


def _batch_inputs(rng, mat, shape, lengths, W):
    """Tiles, slot queries (real lengths ``lengths``), matrix and config."""
    cfg = make_scoring_config(mat)
    A, pad = cfg.alphabet_size, cfg.pad_code
    tiles = torch.as_tensor(_tiles(rng, shape, pad, shape[0] * 4096 - 77, A))
    q = np.full((len(lengths), W), pad, np.int32)
    for s, n in enumerate(lengths):
        q[s, :n] = rng.integers(0, A - 1, size=n)
    m = torch.as_tensor(cfg.matrix.astype(np.int32).reshape(-1))
    return tiles, torch.as_tensor(q), m, cfg


#: Slot lengths: one slot, and eight with an empty one and real lengths
#: that are not multiples of 8 (their padded rows are walked).
BATCH_LENGTHS = {"S1": (37,), "S8": (13, 0, 40, 7, 21, 64, 1, 30)}
#: The cell batch's slot cases: those, three slots with a 0-row and a
#: 1-row one, and fourteen unequal slots.
CELL_BATCH_LENGTHS = {**BATCH_LENGTHS, "S3": (0, 1, 57),
                      "S14": (144, 0, 1, 9, 33, 64, 8, 100, 7, 1, 250, 16, 71, 0)}


@pytest.mark.parametrize("L", [64, 296, 896])
@pytest.mark.parametrize("slots", sorted(CELL_BATCH_LENGTHS))
@pytest.mark.parametrize("mat", MATS)
def test_cell_batch_kernel_equals_plain(dev, mat, slots, L):
    """B4 at a G x R = L instance (64), one with G x R > L (296: 16 x 19),
    and past the largest instance (896: the col wavefront's passes), each
    slot its own row count; the plain version runs on the card."""
    rng = np.random.default_rng(16)
    lengths = CELL_BATCH_LENGTHS[slots]
    tiles, q, m, cfg = _batch_inputs(rng, mat, (2, L, 32, 128), lengths, 256)
    _edge_lanes(tiles, cfg.pad_code, rng)
    params = (0, cfg.gop, cfg.gex, 0, *lengths)
    t, qd, md = tiles.to(dev), q.to(dev), m.to(dev)
    want = sw_cell.score_bucket_cell_batch_plain(t, qd, md, params)
    before = sw_cell.score_bucket_cell_batch.launches
    got = sw_cell.score_bucket_cell_batch(t, qd, md, params)
    torch.cuda.synchronize()
    assert sw_cell.score_bucket_cell_batch.launches == before + 1
    assert torch.equal(got, want)
    assert not bool(got[[k for k, n in enumerate(lengths) if n == 0]].any())


@pytest.mark.parametrize("slots", sorted(BATCH_LENGTHS))
@pytest.mark.parametrize("mat", MATS)
def test_col_flat_and_fused_kernels_equal_plain(dev, mat, slots):
    rng = np.random.default_rng(17)
    lengths = BATCH_LENGTHS[slots]
    nqps = [max(8, -(-n // 8) * 8) for n in lengths]
    tiles, q, m, cfg = _batch_inputs(rng, mat, (2, 256, 32, 128), lengths, 64)
    params = (0, cfg.gop, cfg.gex, 0, *nqps)
    offs = tuple(64 * s for s in range(len(nqps)))
    want = sw_col.score_bucket_col_flat_plain(tiles, q, m, params)
    t, qd, md = tiles.to(dev), q.to(dev), m.to(dev)
    flat0 = sw_col.score_bucket_col_flat.launches
    fused0 = sw_col.score_bucket_col_flat_fused.launches
    got = sw_col.score_bucket_col_flat(t, qd, md, params, offs, rtot=512)
    got_f = sw_col.score_bucket_col_flat_fused(t, qd, md, params, rtot=512)
    torch.cuda.synchronize()
    assert sw_col.score_bucket_col_flat.launches == flat0 + 1
    assert sw_col.score_bucket_col_flat_fused.launches == fused0 + 1
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got_f.cpu(), want)


#: B6's gapless slots: an empty one, slots that start at offsets no
#: multiple of 32 (8, 48, 88, 152) and cross 32-row groups of the pool.
FUSED_NQPS = (8, 0, 40, 40, 24, 64, 8)


@pytest.mark.parametrize("L", [512, 1152])
@pytest.mark.parametrize("mat", MATS)
def test_col_fused_gapless_slots_equal_plain(dev, mat, L):
    """B6 on one pass of FUSED_NQPS at L = 512 (one pass: no pool) and
    L = 1152 (three passes through the gapless pool), against the plain
    version and the flat kernel on the card; real rows below each nqp."""
    rng = np.random.default_rng(19 + L)
    lens = [max(0, n - 3) for n in FUSED_NQPS]
    tiles, q, m, cfg = _batch_inputs(rng, mat, (2, L, 32, 128), lens, 64)
    _edge_lanes(tiles, cfg.pad_code, rng)
    params = (0, cfg.gop, cfg.gex, 0, *FUSED_NQPS)
    t, qd, md = tiles.to(dev), q.to(dev), m.to(dev)
    want = sw_col.score_bucket_col_flat_plain(t, qd, md, params)
    before = sw_col.score_bucket_col_flat_fused.launches
    got = sw_col.score_bucket_col_flat_fused(t, qd, md, params, rtot=256)
    offs = tuple(64 * s for s in range(len(FUSED_NQPS)))
    flat = sw_col.score_bucket_col_flat(t, qd, md, params, offs, rtot=512)
    torch.cuda.synchronize()
    assert sw_col.score_bucket_col_flat_fused.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(flat, want)
    assert not bool(got[1].any())


def test_engine_batch_cuda_equals_cpu_and_singles(dev, monkeypatch):
    """scan_batch on the card, with the fused col kernel for passes of two
    slots or more, against the CPU and against the card's single scans."""
    monkeypatch.setattr(sw_col, "COL_FUSE_MIN_S", 2)
    rng = np.random.default_rng(18)
    cfg = make_scoring_config("blosum62")
    pad = cfg.pad_code
    buckets, base = [], 0
    for L, kind, ns in ((32, "row", 128), (64, "cell", 4096), (256, "col", 4096)):
        cnt = ns - 5
        tiles = _tiles(rng, (1, L, ns) if kind == "row" else (1, L, 32, 128), pad, cnt, 21)
        sidx = np.full((1, ns), -1, np.int32)
        sidx[0, :cnt] = np.arange(base, base + cnt)
        buckets.append(PackedBucket(L=L, NS=ns, tiles=tiles, seq_index=sidx,
                                    lengths=(sidx >= 0).astype(np.int32) * L, kernel=kind))
        base += cnt
    packed = PackedDB(buckets=buckets, num_sequences=base, total_real_chars=base)
    queries = [rng.integers(0, 20, size=n).astype(np.int8) for n in (17, 120, 3, 64, 250)]
    results = []
    for device in ("cpu", "cuda"):
        eng = SearchEngine(scoring=cfg, num_top=25, device=device)
        eng.set_database(None, packed=packed)
        results.append([(r.scores, r.reference_ids) for r in eng.scan_batch(queries)])
    assert results[0] == results[1]
    assert results[1] == [(r.scores, r.reference_ids) for r in map(eng.scan, queries)]


def test_batch_wrappers_reject_bad_arguments(dev):
    m = torch.zeros(441, dtype=torch.int32, device=dev)
    q = torch.zeros((2, 16), dtype=torch.int32, device=dev)
    t = torch.zeros((1, 128, 32, 128), dtype=torch.int8, device=dev)
    p = (0, -11, -1, 0, 8, 8)
    with pytest.raises(ValueError):  # int32 tiles
        sw_cell.score_bucket_cell_batch(t.int(), q, m, p)
    with pytest.raises(ValueError):  # query block on the CPU
        sw_cell.score_bucket_cell_batch(t, q.cpu(), m, p)
    with pytest.raises(ValueError):  # slot rows overlap
        sw_col.score_bucket_col_flat(t, q, m, p, (0, 4), rtot=64)
    with pytest.raises(ValueError):  # slots exceed the pool
        sw_col.score_bucket_col_flat_fused(t, q, m, (0, -11, -1, 0, 16, 16), rtot=24)
    with pytest.raises(ValueError):  # rows not a multiple of the unroll
        sw_col.score_bucket_col_flat_fused(t, q, m, (0, -11, -1, 0, 8, 5), rtot=64)


# ------------------------------------------- int16 state, B7 and B8

#: The default SAT, and one lowered so that most random subjects saturate.
SATS = [32000, 30]


def _sat_lanes_equal(got_state, want_state, want_scores, sat):
    """Carried H/F rows agree on every subject whose score is below sat
    (a saturated subject's state is free under the SAT rule)."""
    T = want_scores.shape[0]
    live = (want_scores < sat).reshape(T, 1, 32, 128)
    return all(torch.equal(g.cpu()[live.expand_as(w)], w[live.expand_as(w)])
               for g, w in zip(got_state, want_state))


@pytest.mark.parametrize("sat", SATS)
@pytest.mark.parametrize("mat", MATS)
def test_cell16_kernel_meets_sat_rule(dev, monkeypatch, mat, sat):
    monkeypatch.setattr(sw_cell, "SAT", sat)
    rng = np.random.default_rng(21)
    cfg = make_scoring_config(mat)
    A, pad = cfg.alphabet_size, cfg.pad_code
    tiles = torch.as_tensor(_tiles(rng, (2, 64, 32, 128), pad, 2 * 4096 - 100, A))
    q = torch.as_tensor(_query(rng, 53, 256, pad, A))
    m = torch.as_tensor(cfg.matrix.astype(np.int32).reshape(-1))
    params = (53, cfg.gop, cfg.gex, 56)
    want16 = sw_cell.score_bucket_cell_plain(tiles, q, m, params, exact=False)
    exact = sw_cell.score_bucket_cell_plain(tiles, q, m, params)
    before = sw_cell.score_bucket_cell.launches16
    got = sw_cell.score_bucket_cell(tiles.to(dev), q.to(dev), m.to(dev), params, exact=False).cpu()
    assert sw_cell.score_bucket_cell.launches16 == before + 1
    assert bool(sw_cell.sat_match(got, want16).all())
    assert bool(sw_cell.sat_match(got, exact).all())
    if sat == 30:
        assert int((exact >= sat).sum()) > 100  # the lowered SAT flags subjects


@pytest.mark.parametrize("sat", SATS)
@pytest.mark.parametrize("mat", MATS)
def test_col16_kernel_carry_meets_sat_rule(dev, monkeypatch, mat, sat):
    """int16 state over two chunks with the int32 carry between them."""
    monkeypatch.setattr(sw_cell, "SAT", sat)
    rng = np.random.default_rng(22)
    cfg = make_scoring_config(mat)
    A, pad = cfg.alphabet_size, cfg.pad_code
    tiles = torch.as_tensor(_tiles(rng, (2, 256, 32, 128), pad, 2 * 4096, A))
    m = torch.as_tensor(cfg.matrix.astype(np.int32).reshape(-1))
    t_dev, m_dev = tiles.to(dev), m.to(dev)
    q1 = torch.as_tensor(_query(rng, 40, 64, pad, A))
    q2 = torch.as_tensor(_query(rng, 21, 64, pad, A))
    p1, p2 = (40, cfg.gop, cfg.gex, 0), (24, cfg.gop, cfg.gex, 0)
    ex1, _ = sw_col.score_bucket_col_plain(tiles, q1, m, p1, emit_state=True)
    w1, st1w = sw_col.score_bucket_col_plain(tiles, q1, m, p1, emit_state=True, exact=False)
    s1, st1 = sw_col.score_bucket_col(t_dev, q1.to(dev), m_dev, p1, emit_state=True, exact=False)
    assert all(s.dtype == torch.int32 for s in st1)
    assert bool(sw_cell.sat_match(s1.cpu(), w1).all())
    assert bool(sw_cell.sat_match(s1.cpu(), ex1).all())
    assert _sat_lanes_equal(st1, st1w, ex1, sat)
    w2 = sw_col.score_bucket_col_plain(tiles, q2, m, p2, state_in=st1w, exact=False)
    s2 = sw_col.score_bucket_col(t_dev, q2.to(dev), m_dev, p2, state_in=st1, take_init=True,
                                 exact=False)
    both_w = torch.maximum(w1, w2)
    assert bool(sw_cell.sat_match(torch.maximum(s1, s2).cpu(), both_w).all())


@pytest.mark.parametrize("sat", SATS)
@pytest.mark.parametrize("L", [64, 296, 896])
@pytest.mark.parametrize("slots", ["S3", "S14"])
def test_cell_batch16_kernel_meets_sat_rule(dev, monkeypatch, slots, L, sat):
    """B4 int16 at a G x R = L instance (64), one with G x R > L (296) and
    past the largest instance (896: col flat in int16 state), unequal
    slots with 0-row and 1-row ones: against its plain int16 and exact
    versions under the SAT rule, and slot by slot equal to the single-query
    int16 kernel (B1 int16, or B3 int16 at 896)."""
    monkeypatch.setattr(sw_cell, "SAT", sat)
    rng = np.random.default_rng(25)
    lengths = CELL_BATCH_LENGTHS[slots]
    tiles, q, m, cfg = _batch_inputs(rng, "blosum62", (2, L, 32, 128), lengths, 256)
    _edge_lanes(tiles, cfg.pad_code, rng)
    params = (0, cfg.gop, cfg.gex, 0, *lengths)
    t, qd, md = tiles.to(dev), q.to(dev), m.to(dev)
    want16 = sw_cell.score_bucket_cell_batch_plain(t, qd, md, params, exact=False)
    exact = sw_cell.score_bucket_cell_batch_plain(t, qd, md, params)
    fn = sw_cell.score_bucket_cell_batch
    before = (fn.launches, fn.launches16)
    got = fn(t, qd, md, params, exact=False)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches16) == (before[0], before[1] + 1)
    assert bool(sw_cell.sat_match(got, want16).all())
    assert bool(sw_cell.sat_match(got, exact).all())
    if sat == 30:
        assert int((exact >= sat).sum()) > 100  # the lowered SAT flags subjects
    else:
        assert torch.equal(got, exact)
    for s, n in enumerate(lengths):
        single = sw_cell.score_bucket_cell(t, qd[s].contiguous(), md, (n, cfg.gop, cfg.gex, n),
                                           exact=False)
        assert torch.equal(got[s], single), f"slot {s} ({n} rows)"


@pytest.mark.parametrize("sat", SATS)
@pytest.mark.parametrize("L", [256, 1152])
@pytest.mark.parametrize("mat", MATS)
def test_col_flat16_and_fused16_kernels_meet_sat_rule(dev, monkeypatch, mat, L, sat):
    """B5 and B6 int16 on eight ragged slots (one empty), in one pass (256)
    and over three passes through the int16 pool (1152), against the plain
    int16 and exact versions under the SAT rule; the two kernels agree."""
    monkeypatch.setattr(sw_cell, "SAT", sat)
    rng = np.random.default_rng(26)
    lengths = BATCH_LENGTHS["S8"]
    nqps = [max(8, -(-n // 8) * 8) for n in lengths]
    tiles, q, m, cfg = _batch_inputs(rng, mat, (2, L, 32, 128), lengths, 64)
    _edge_lanes(tiles, cfg.pad_code, rng)
    params = (0, cfg.gop, cfg.gex, 0, *nqps)
    offs = tuple(64 * s for s in range(len(nqps)))
    t, qd, md = tiles.to(dev), q.to(dev), m.to(dev)
    want16 = sw_col.score_bucket_col_flat_plain(t, qd, md, params, exact=False)
    exact = sw_col.score_bucket_col_flat_plain(t, qd, md, params)
    flat, fused = sw_col.score_bucket_col_flat, sw_col.score_bucket_col_flat_fused
    before = (flat.launches16, fused.launches16, flat.launches, fused.launches)
    got = flat(t, qd, md, params, offs, rtot=512, exact=False)
    got_f = fused(t, qd, md, params, rtot=512, exact=False)
    torch.cuda.synchronize()
    assert (flat.launches16, fused.launches16, flat.launches, fused.launches) == (
        before[0] + 1, before[1] + 1, before[2], before[3])
    for g in (got, got_f):
        assert bool(sw_cell.sat_match(g, want16).all())
        assert bool(sw_cell.sat_match(g, exact).all())
    assert torch.equal(got, got_f)
    if sat == 30:
        assert int((exact >= sat).sum()) > 100
    else:
        assert torch.equal(got, exact)


def _no_scratch(dev, fn, out_bytes, L):
    """Call ``fn`` on the card; on the cell route (``L`` of a cell
    instance) assert that it allocated at most its scores (``out_bytes``)
    plus 1 MB.  Returns its result."""
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    got = fn()
    torch.cuda.synchronize(dev)
    if sw_cell.cell_shape(L):
        assert torch.cuda.max_memory_allocated(dev) - base <= out_bytes + (1 << 20)
    return got


@pytest.mark.parametrize("mat", MATS)
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("L", [40, 136, 300, 640, 768, 800])
def test_manual_kernel_equals_cell_plain(dev, monkeypatch, mat, exact, L):
    """B7 over 4 tiles at SAT 30: one instance of each group width (8, 16
    and 32 lanes) up to the largest, L = 768, with several ring units a
    block at the longer L, the int16 pairwise table of both alphabets (75.8
    KB at A = 26), and the col route past 768, each launch counted on B7's
    wrapper; an empty query scores 0.  On the cell route (L <= 768) the
    call allocates no scratch."""
    monkeypatch.setattr(sw_cell, "SAT", 30)
    rng = np.random.default_rng(23)
    cfg = make_scoring_config(mat)
    A, pad = cfg.alphabet_size, cfg.pad_code
    tiles = torch.as_tensor(_tiles(rng, (4, L, 32, 128), pad, 4 * 4096 - 9, A))
    _edge_lanes(tiles, pad, rng)
    q = torch.as_tensor(_query(rng, 45, 128, pad, A))
    m = torch.as_tensor(cfg.matrix.astype(np.int32).reshape(-1))
    params = (45, cfg.gop, cfg.gex, 48)
    want = sw_cell.score_bucket_cell_plain(tiles, q, m, params, exact=exact)
    t, qd, md = tiles.to(dev), q.to(dev), m.to(dev)
    fn = sw_cell.score_bucket_cell_manual
    mode = "launches" if exact else "launches16"
    before = (getattr(fn, mode), fn.plain_calls + fn.plain_calls16)
    got = _no_scratch(dev, lambda: fn(t, qd, md, params, exact=exact), 4 * 4096 * 4, L)
    assert (getattr(fn, mode), fn.plain_calls + fn.plain_calls16) == (before[0] + 1, before[1])
    got = got.cpu()
    if exact:
        assert torch.equal(got, want)
    else:
        assert bool(sw_cell.sat_match(got, want).all())
        assert int((want >= 30).sum()) > 0
    empty = fn(t, qd, md, (0, cfg.gop, cfg.gex, 8), exact=exact)
    assert not bool(empty.any())


@pytest.mark.parametrize("L", [40, 640, 800])
@pytest.mark.parametrize("P", [1, 2, 4])
def test_pair_kernel_equals_cell_plain(dev, P, L):
    """B8 over 4 tiles at P tiles a block, on one instance of each end of
    the cell shapes and on the col route past 768; on the cell route the
    call allocates no scratch."""
    from cudasw4_tpu_torch.tools.pairbench import score_pair

    rng = np.random.default_rng(24)
    cfg = make_scoring_config("blosum62_full")
    A, pad = cfg.alphabet_size, cfg.pad_code
    tiles = torch.as_tensor(_tiles(rng, (4, L, 32, 128), pad, 4 * 4096 - 3, A))
    q = torch.as_tensor(_query(rng, 37, 64, pad, A))
    m = torch.as_tensor(cfg.matrix.astype(np.int32).reshape(-1))
    params = (37, cfg.gop, cfg.gex, 40)
    want = sw_cell.score_bucket_cell_plain(tiles, q, m, params)
    t, qd, md = tiles.to(dev), q.to(dev), m.to(dev)
    before = score_pair.launches
    got = _no_scratch(dev, lambda: score_pair(t, qd, md, params, P=P), 4 * 4096 * 4, L)
    assert score_pair.launches == before + 1
    assert torch.equal(got.cpu(), want)


def _stream_packed(rng, cfg, layout=((32, "row", 128, 24), (64, "cell", 4096, 10),
                                      (256, "col", 4096, 6))):
    """A packed database of many small tiles, by default 24 row tiles (L =
    32), 10 cell tiles (L = 64) and 6 col tiles (L = 256); ``layout``:
    (L, kind, NS, T) a bucket.  The last tile of each bucket is partly
    empty."""
    pad = cfg.pad_code
    buckets, base = [], 0
    for L, kind, ns, T in layout:
        cnt = T * ns - 7
        shape = (T, L, ns) if kind == "row" else (T, L, 32, 128)
        tiles = _tiles(rng, shape, pad, cnt, cfg.alphabet_size)
        sidx = np.full(T * ns, -1, np.int32)
        sidx[:cnt] = np.arange(base, base + cnt)
        sidx = sidx.reshape(T, ns)
        buckets.append(PackedBucket(L=L, NS=ns, tiles=tiles, seq_index=sidx,
                                    lengths=(sidx >= 0).astype(np.int32) * L, kernel=kind))
        base += cnt
    return PackedDB(buckets=buckets, num_sequences=base, total_real_chars=base * 40)


#: (staging depth, resident prefix, codec mode).
STREAM_CASES = [(1, "0", "1"), (2, "1", "1"), (2, "0", "2"), (2, "0", "0")]


@pytest.mark.parametrize("depth,resident,codec", STREAM_CASES)
def test_streamed_pass_equals_resident_on_card(dev, monkeypatch, depth, resident, codec):
    """A streamed pass on the card (one tile a chunk, 38 chunks without a
    prefix) gives the resident engine's results, at staging depth 1 and 2,
    with and without a resident prefix, for each codec: a slot refilled
    before the card read it, or a device buffer overwritten under a
    kernel, would change scores.  The budget is the pass's working memory
    and half the tiles."""
    import functools

    from cudasw4_tpu_torch.engine_streaming import stream_work_bytes

    monkeypatch.setenv("CUDASW4_TPU_TORCH_STREAM_RESIDENT", resident)
    monkeypatch.setenv("CUDASW4_TPU_TORCH_STREAM_PACK", codec)
    rng = np.random.default_rng(31)
    cfg = make_scoring_config("blosum62")
    packed = _stream_packed(rng, cfg)
    lengths = [int(n) for n in rng.integers(5, 400, size=20)] + [3100, 3500]
    queries = [rng.integers(0, 20, size=n).astype(np.int8) for n in lengths]
    resident_eng = SearchEngine(scoring=cfg, num_top=15, device="cuda")
    resident_eng.set_database(None, packed=packed)
    want = [(r.scores, r.reference_ids) for r in resident_eng.scan_many(queries)]
    shapes = [(b.L, b.NS, b.kernel, b.num_tiles) for b in packed.buckets]
    work = stream_work_bytes(shapes, 300_000, 128)[0]
    eng = SearchEngine(scoring=cfg, num_top=15, device="cuda",
                       max_device_bytes=work + packed.total_padded_chars // 2,
                       stream_chunk_bytes=300_000, max_batch_sequences=128)
    eng.set_database(None, packed=packed)
    assert eng.streaming and bool(eng._resident_chunks) == (resident == "1")
    monkeypatch.setattr(eng, "_scan_chunks", functools.partial(
        type(eng)._scan_chunks, eng, depth=depth))
    for _ in range(2):
        got = [(r.scores, r.reference_ids) for r in eng.scan_many(queries)]
        assert got == want
    stats = eng.stream_copy_stats()
    assert stats["chunks"] == 40 - sum(eng._res_tiles.values()) and stats["copy_ms"] > 0
    torch.cuda.synchronize()


def test_stream_spans_share_the_device_clock(dev, monkeypatch):
    """A traced streamed scan (six one-tile cell chunks, raw tiles, no
    prefix): each chunk's ``sw:stream_read`` host range ends before the
    host-to-device copies it feeds start on the ring's copy stream, and
    those end before the chunk's batch kernel starts, so host ranges and
    device events lie on one clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setenv("CUDASW4_TPU_TORCH_STREAM_RESIDENT", "0")
    monkeypatch.setenv("CUDASW4_TPU_TORCH_STREAM_PACK", "0")
    rng = np.random.default_rng(35)
    cfg = make_scoring_config("blosum62")
    packed = _stream_packed(rng, cfg, layout=((64, "cell", 4096, 6),))
    eng = SearchEngine(scoring=cfg, num_top=15, device="cuda", max_device_bytes=1,
                       stream_chunk_bytes=300_000)
    eng.set_database(None, packed=packed)
    q = rng.integers(0, 20, size=100).astype(np.int8)
    want = eng.scan(q)  # the first launches stay out of the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = eng.scan(q)
        torch.cuda.synchronize()
    assert (got.scores, got.reference_ids) == (want.scores, want.reference_ids)
    reads, copies, kernels = [], [], []
    for e in prof.profiler.kineto_results.events():
        ab = (e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() != DeviceType.CUDA:
            if e.name() == "sw:stream_read":
                reads.append(ab)
        elif not e.is_user_annotation():
            if e.name().startswith("Memcpy HtoD"):
                copies.append((*ab, e.device_resource_id()))
            elif "sw_cell" in e.name():
                kernels.append((*ab, e.device_resource_id()))
    compute = {s for *_, s in kernels}
    ring = sorted(c for c in copies if c[2] not in compute)  # the copy stream's
    reads.sort()
    kernels.sort()
    assert len(reads) == eng.stream_copy_stats()["chunks"] == 6
    assert len(ring) == 2 * len(reads) and len(kernels) == len(reads), (ring, kernels)
    for k, (_, read_end) in enumerate(reads):
        chunk, sidx = ring[2 * k : 2 * k + 2]
        assert read_end <= chunk[0], (k, reads, ring)
        assert max(chunk[1], sidx[1]) <= kernels[k][0], (k, ring, kernels)


@pytest.mark.parametrize("mode", ["resident", "streamed", "state16"])
def test_mesh_of_two_shards_equals_single_on_card(dev, monkeypatch, mode):
    """Two shards (two cards where there are, else both on one card, each
    on its own stream) give the single device's results: resident, streamed
    (one-tile chunks split over the shards, a per-shard prefix of half the
    tiles), and in int16 state at a SAT low enough that tiles flag on both
    shards (the mesh re-score, its candidates copied back without
    blocking)."""
    from cudasw4_tpu_torch.engine_streaming import stream_work_bytes
    from cudasw4_tpu_torch.parallel.sharding import make_mesh

    rng = np.random.default_rng(34)
    cfg = make_scoring_config("blosum62")
    packed = _stream_packed(rng, cfg)
    lengths = [int(n) for n in rng.integers(5, 400, size=20)] + [3100, 3500]
    queries = [rng.integers(0, 20, size=n).astype(np.int8) for n in lengths]
    single = SearchEngine(scoring=cfg, num_top=15, device="cuda")
    single.set_database(None, packed=packed)
    want = [(r.scores, r.reference_ids) for r in single.scan_many(queries)]
    devices = ["cuda:0", "cuda:1"] if torch.cuda.device_count() > 1 else ["cuda:0"] * 2
    kw = {}
    if mode == "streamed":
        shapes = [(b.L, b.NS, b.kernel, b.num_tiles) for b in packed.buckets]
        kw = dict(max_device_bytes=stream_work_bytes(shapes, 300_000, 128, 20, 2)[0]
                  + packed.total_padded_chars // 4,
                  stream_chunk_bytes=300_000, max_batch_sequences=128)
    eng = SearchEngine(scoring=cfg, num_top=15, mesh=make_mesh(devices), **kw)
    eng.set_database(None, packed=packed)
    assert eng.streaming == (mode == "streamed")
    if mode == "state16":
        eng.state16 = True
        monkeypatch.setattr(sw_cell, "SAT", min(s[0] for s, _ in want))
    for _ in range(2):
        got = [(r.scores, r.reference_ids) for r in eng.scan_many(queries)]
        assert got == want
    if mode == "state16":
        got = [eng.scan(q) for q in queries[:3]]
        assert all(r.stats.num_overflows > 0 for r in got)
    torch.cuda.synchronize()


def test_cell_batch_and_col_plan_at_20_slots(dev):
    """B4 with 20 slots and a col_flat_plan of 20 slots (at most 8 a pass)
    through batch_col_scores, as a streamed pass of QB_STREAM = 20 queries
    launches them, against their plain versions (run on the card)."""
    from cudasw4_tpu_torch.ops import batch_col_scores, col_flat_plan

    rng = np.random.default_rng(32)
    cfg = make_scoring_config("blosum62")
    A, pad = cfg.alphabet_size, cfg.pad_code
    m = torch.as_tensor(cfg.matrix.astype(np.int32).reshape(-1)).to(dev)
    lens = [int(n) for n in rng.integers(0, 200, size=20)]
    qs = torch.as_tensor(np.stack([_query(rng, n, 256, pad, A) for n in lens])).to(dev)
    cell = torch.as_tensor(_tiles(rng, (2, 64, 32, 128), pad, 2 * 4096 - 9, A)).to(dev)
    p = (0, cfg.gop, cfg.gex, 0, *lens)
    got = sw_cell.score_bucket_cell_batch(cell, qs, m, p)
    assert got.shape == (20, 2, 4096)
    assert torch.equal(got, sw_cell.score_bucket_cell_batch_plain(cell, qs, m, p))
    col = torch.as_tensor(_tiles(rng, (1, 640, 32, 128), pad, 4000, A)).to(dev)
    pads = [sw_col.padded_rows(n) for n in lens]
    plan = col_flat_plan(pads, limit=20)
    assert sorted(s for ps in plan for s, _ in ps) == list(range(20))
    assert all(len(ps) <= 8 for ps in plan) and len(plan) >= 3
    params = (0, cfg.gop, cfg.gex, 0, *lens, *pads)
    got = [None] * 20
    for part, slots in batch_col_scores(col, qs, m, params, 20, plan):
        for k, slot in enumerate(slots):
            got[slot] = part[k]
    want = sw_col.score_bucket_col_flat_plain(col, qs, m, (0, cfg.gop, cfg.gex, 0, *pads))
    assert torch.equal(torch.stack(got), want)


@pytest.mark.parametrize("codec", ["b32", "b21"])
def test_unpack_on_card_equals_numpy(dev, codec):
    from cudasw4_tpu_torch.ops import pack5

    rng = np.random.default_rng(33)
    tiles = rng.integers(0, 21, size=(3, 100, 32, 128)).astype(np.int8)
    words = pack5.CODECS[codec][2](tiles)
    got = pack5.CODECS[codec][3](torch.as_tensor(words).to(dev), (100, 32, 128))
    assert got.device.type == "cuda" and got.is_contiguous()
    assert np.array_equal(got.cpu().numpy(), pack5.CODECS[codec][4](words, (100, 32, 128)))
    assert np.array_equal(got.cpu().numpy(), tiles)


def test_split_library_exports_every_launcher(dev):
    """The library, linked from its units (cuda_lib.UNITS), exports every
    launch function that lib() binds."""
    import ctypes

    handle = ctypes.CDLL(str(cuda_lib.build()))
    names = {*cuda_lib.LAUNCHES.values(), *cuda_lib.CELL_LAUNCHES.values(),
             *cuda_lib.COL_LAUNCHES.values(), *cuda_lib.TOOL_LAUNCHES.values(),
             "sw_col_pass_columns", "sw_cell_shapes", "sw_error_string"}
    assert sorted(n for n in names if not hasattr(handle, n)) == []
    assert len(list(cuda_lib.object_dir().glob("unit*.o"))) == len(cuda_lib.UNITS)


@pytest.mark.parametrize("state16", [False, True])
@pytest.mark.parametrize("col_tiles", [None, 4])
def test_warmup_launches_each_single_scan_kernel(dev, state16, col_tiles):
    """warmup() on a database of one row, one cell and one col bucket
    launches B2 once, B1 once a state mode, and B3 once plus three carry
    variants a col tile group (two groups when the col temp budget holds
    four of the six tiles); the results do not change."""
    from cudasw4_tpu_torch.engine import _kernel_launches

    rng = np.random.default_rng(41)
    cfg = make_scoring_config("blosum62")
    packed = _stream_packed(rng, cfg)
    per_tile = 8 * 256 * 4096 + cuda_lib.col_boundary_bytes(1, sw_col.NQC)
    temp = None if col_tiles is None else col_tiles * per_tile
    queries = [rng.integers(0, 20, size=n).astype(np.int8) for n in (30, 200, 3500)]
    cold = SearchEngine(scoring=cfg, num_top=15, device="cuda", col_temp_bytes=temp)
    cold.state16 = state16
    cold.set_database(None, packed=packed)
    want = [(r.scores, r.reference_ids) for r in cold.scan_many(queries)]
    eng = SearchEngine(scoring=cfg, num_top=15, device="cuda", col_temp_bytes=temp)
    eng.state16 = state16
    eng.set_database(None, packed=packed)
    counters = (sw_cell.score_bucket_cell, "launches"), (sw_cell.score_bucket_cell, "launches16"), \
        (sw_row.score_bucket_row, "launches"), (sw_col.score_bucket_col, "launches"), \
        (sw_col.score_bucket_col, "launches16")
    before = [getattr(fn, a) for fn, a in counters]
    start = _kernel_launches()
    n = eng.warmup()
    got = [getattr(fn, a) - b for (fn, a), b in zip(counters, before)]
    groups = 1 if col_tiles is None else 2
    assert got == [1, int(state16), 1, 1 + 3 * groups, int(state16)]
    assert n == sum(got) == _kernel_launches() - start
    assert [(r.scores, r.reference_ids) for r in eng.scan_many(queries)] == want


def test_gridsearch_cell_and_col_rows_on_card(dev, tmp_path):
    from cudasw4_tpu_torch.cli import gridsearch

    tsv, cfg = tmp_path / "sweep.tsv", tmp_path / "tuning.json"
    assert gridsearch.run(["--lengths", "128,256", "--querylengths", "64", "--chars",
                           str(4096 * 256), "--kernels", "cell,col", "--reps", "1",
                           "--of", str(tsv), "--emit-config", str(cfg)]) == 0
    rows = [line.split("\t") for line in tsv.read_text().splitlines()[1:]]
    assert sorted((r[0], int(r[1])) for r in rows) == [
        ("cell", 128), ("cell", 256), ("col", 128), ("col", 256)]
    assert all(float(r[6]) > 0 for r in rows)
    import json

    assert json.loads(cfg.read_text())["platform"] == torch.cuda.get_device_name(0)


def test_device_trace_names_a_port_kernel(dev, tmp_path):
    import json

    from cudasw4_tpu_torch.utils.profiling import device_trace, span

    rng = np.random.default_rng(42)
    cfg = make_scoring_config("blosum62")
    t = torch.as_tensor(_tiles(rng, (2, 64, 32, 128), cfg.pad_code, 8000, 21)).cuda()
    q = torch.as_tensor(rng.integers(0, 20, size=64).astype(np.int32)).cuda()
    m = torch.as_tensor(cfg.matrix.astype(np.int32).reshape(-1)).cuda()
    with device_trace(str(tmp_path)) as path:
        with span("sw:bucket cell L=64", t.device):
            sw_cell.score_bucket_cell(t, q, m, (64, cfg.gop, cfg.gex, 64))
    names = [e.get("name", "") for e in json.load(open(path))["traceEvents"]]
    assert any("sw_cell16_kernel" in n for n in names)
    assert "sw:bucket cell L=64" in names


def test_device_trace_holds_every_launch(dev, tmp_path):
    """Twenty traces in one process, each of a row and a cell launch made
    as soon as the trace starts: every trace holds both kernels, as
    chip_smoke's idle shares require (they are given only where a trace's
    kernels number the wrappers' launches)."""
    import json

    from cudasw4_tpu_torch.utils.profiling import device_trace

    rng = np.random.default_rng(43)
    cfg = make_scoring_config("blosum62")
    m = torch.as_tensor(cfg.matrix.astype(np.int32).reshape(-1)).cuda()
    rt = torch.as_tensor(rng.integers(0, 20, size=(2, 48, 128)).astype(np.int8)).cuda()
    ct = torch.as_tensor(rng.integers(0, 20, size=(1, 64, 32, 128)).astype(np.int8)).cuda()
    q = torch.as_tensor(rng.integers(0, 20, size=64).astype(np.int32)).cuda()
    p = (64, cfg.gop, cfg.gex, 64)
    for k in range(20):
        with device_trace(str(tmp_path), f"t{k}.json") as path:
            sw_row.score_bucket_row(rt, q, m, p)
            sw_cell.score_bucket_cell(ct, q, m, p)
        names = [e["name"] for e in json.load(open(path))["traceEvents"]
                 if e.get("cat") == "kernel"]
        assert [sum(f"::{kernel}<" in n for n in names)
                for kernel in ("sw_row_kernel", "sw_cell16_kernel")] == [1, 1]


@pytest.mark.parametrize("trial", range(3))
def test_fuzz_modes_agree_on_card(dev, trial):
    """tests/test_torch_fuzz_modes.py's trial on the card: single, batched,
    streamed and two-shard mesh scans of random databases (length-1
    subjects, duplicates, empty and 1-residue queries) equal the resident
    single scan."""
    from test_torch_fuzz_modes import fuzz_trial

    fuzz_trial(trial, "cuda")


