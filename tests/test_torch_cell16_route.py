"""Exact cell launches in s16x2 lanes: the host's copy of the kernel's fit
(``cuda_lib.cell16_bmax``, ``cell16_fits``) against brute-force DP scores
of the plain version, the matrices' noted score range, and the launches'
arguments and slot counters on "meta" tensors with the kernel library
replaced by a recorder (no card needed).
"""

import contextlib

import numpy as np
import pytest
import torch

from cudasw4_tpu_torch import make_scoring_config
from cudasw4_tpu_torch.db.format import pseudo_to_dbdata
from cudasw4_tpu_torch.db.pseudo import make_pseudo_db
from cudasw4_tpu_torch.engine import SearchEngine
from cudasw4_tpu_torch.ops import cuda_lib, sw_cell
from cudasw4_tpu_torch.ops.sw_torch import sweep_tiles_torch
from cudasw4_tpu_torch.parallel import sharding

# (L, nrows, gop, gex, bmax): min(L, nrows) sets the bound, 16383 caps it,
# and a gap outside [-8192, 0] fits no matrix.
BMAX_CASES = [
    (768, 464, -11, -1, 32767 // 464),
    (64, 464, -11, -1, 32767 // 64),
    (464, 768, -11, -1, 32767 // 464),
    (768, 3, -11, -1, 32767 // 3),
    (768, 2, -11, -1, 16383),
    (768, 1, -11, -1, 16383),
    (1, 768, -11, -1, 16383),
    (768, 0, -11, -1, 16383),
    (640, 464, 0, 0, 32767 // 464),
    (640, 464, -8192, -8192, 32767 // 464),
    (640, 464, 1, -1, -8193),
    (640, 464, -11, 1, -8193),
    (640, 464, -8193, -1, -8193),
    (640, 464, -11, -8193, -8193),
]


@pytest.mark.parametrize("L,nrows,gop,gex,bmax", BMAX_CASES)
def test_cell16_bmax_mirrors_the_kernel(L, nrows, gop, gex, bmax):
    assert cuda_lib.cell16_bmax(L, nrows, gop, gex) == bmax
    assert cuda_lib.cell16_fits(L, nrows, gop, gex, -4, 11) == (bmax >= 11)  # blosum62
    if bmax >= 0:
        assert cuda_lib.cell16_fits(L, nrows, gop, gex, -4, bmax)
        assert not cuda_lib.cell16_fits(L, nrows, gop, gex, -4, bmax + 1)


@pytest.mark.parametrize("lo,fits", [(-8192, True), (-8193, False), (-30000, False)])
def test_cell16_fit_refuses_entries_below_8192(lo, fits):
    """A matrix entry below -8192 could carry a diagonal sum below -32768."""
    assert cuda_lib.cell16_fits(64, 9, -11, -1, lo, 11) is fits


def _best(x, q, mat, gop, gex):
    """The plain version's best H of each subject: int [NS]."""
    best, _, _ = sweep_tiles_torch(x, q, mat, gop, gex)
    return best[0]


@pytest.mark.parametrize("trial", range(12))
def test_cell16_fit_bounds_every_score(trial):
    """Small random DP problems (512 subjects of L columns, a query of
    nrows rows, random matrices up to 20000 and gaps in [-30, 0]) scored by
    the plain version: every score lies within min(L, nrows) x max B, so
    where the fit holds it lies within 32767; over the trials some
    problems the fit refuses score past 32767."""
    rng = np.random.default_rng(700 + trial)
    A = int(rng.integers(2, 6))
    L, nrows = int(rng.integers(1, 13)), int(rng.integers(1, 13))
    hi = int(rng.integers(0, 20000))
    mat = torch.as_tensor(rng.integers(-hi // 2 - 1, hi + 1, size=(A, A)).astype(np.int32))
    mat[0, 0] = hi  # a code that scores hi against itself
    gop, gex = sorted(int(v) for v in rng.integers(-30, 1, size=2))
    x = torch.as_tensor(rng.integers(0, A, size=(1, L, 512)).astype(np.int8))
    x[0, :, 0] = 0  # subject 0: every column the best code
    q = [0] * nrows
    lo, top = int(mat.min()), int(mat.max())
    best = _best(x, q, mat, gop, gex)
    assert int(best.max()) <= min(L, nrows) * max(top, 0)
    assert int(best[0]) == min(L, nrows) * hi  # the bound is reached
    if cuda_lib.cell16_fits(L, nrows, gop, gex, lo, top):
        assert int(best.max()) <= 32767
    else:
        assert top > cuda_lib.cell16_bmax(L, nrows, gop, gex)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 100, 768])
def test_cell16_fit_is_tight(n):
    """At bmax the best score, n identical columns, fits 16 bits; one more
    and the same alignment passes 32767 (for n >= 3; at n <= 2 the 16383
    cap keeps a score of 2 x bmax + 2 within range)."""
    bmax = cuda_lib.cell16_bmax(n, n, -11, -1)
    x = torch.zeros((1, n, 4), dtype=torch.int8)
    for b, fits in ((bmax, True), (bmax + 1, False)):
        mat = torch.tensor([[b, -1], [-1, 1]], dtype=torch.int32)
        assert cuda_lib.cell16_fits(n, n, -11, -1, -1, b) is fits
        score = int(_best(x, [0] * n, mat, -11, -1)[0])
        assert score == n * b
        assert (score <= 32767) if fits else (n <= 2 or score > 32767)


def test_matrix_range_is_noted_once():
    m = cuda_lib.device_matrix(np.array([[3, -2], [-9, 11]]), "cpu")
    assert m.dtype == torch.int32 and m.shape == (4,) and m.score_range == (-9, 11)
    bare = torch.tensor([5, -7, 2, 0], dtype=torch.int32)
    assert cuda_lib.matrix_range(bare) == (-7, 5)
    bare[0] = 99  # noted: not read again
    assert cuda_lib.matrix_range(bare) == (-7, 5)


def test_engine_and_shards_note_their_matrix_range():
    cfg = make_scoring_config("blosum62")
    want = (int(cfg.matrix.min()), int(cfg.matrix.max()))
    eng = SearchEngine(num_top=3, device="cpu")
    eng.set_database(pseudo_to_dbdata(make_pseudo_db(10, 60)))
    assert eng._matrix_flat.score_range == want
    shards = sharding.make_shards(sharding.make_mesh(["cpu", "cpu"]),
                                  cfg.matrix.astype(np.int32).reshape(-1))
    assert [sh.matrix.score_range for sh in shards] == [want, want]


class _FakeLib:
    """The kernel library's cell launch, recording its arguments."""

    def __init__(self):
        self.calls = []

    def sw_cell_launch(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_lib(monkeypatch):
    fake = _FakeLib()
    monkeypatch.setattr(cuda_lib, "lib", lambda: fake)
    monkeypatch.setattr(cuda_lib, "stream_handle", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    return fake


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_matrix(scale=1):
    """blosum62 (x ``scale``) on "meta", its range noted as the engine
    notes it: a read of the tensor would raise."""
    m = _meta(441, torch.int32)
    m.score_range = (-4 * scale, 11 * scale)
    return m


# (wrapper, L, scale, exact, row counts, slots in s16x2 lanes, in int32
# lanes): B1 is one slot, B4 one a slot of rows > 0; blosum62 x 1000 fits
# s16x2 lanes only over slots of at most two rows; L = 64 is the smallest
# G's instance (8, 8); int16 state counts none.
SLOT_CASES = {
    "B1": ("cell", 128, 1, True, (9,), 1, 0),
    "B1 x1000": ("cell", 128, 1000, True, (9,), 0, 1),
    "B1 x1000 one row": ("cell", 128, 1000, True, (1,), 1, 0),
    "B1 int16": ("cell", 128, 1, False, (9,), 0, 0),
    "B1 at L = 64": ("cell", 64, 1, True, (9,), 1, 0),
    "B4": ("batch", 128, 1, True, (16, 0, 9), 2, 0),
    "B4 x1000": ("batch", 128, 1000, True, (1, 0, 2, 9, 40), 2, 2),
    "B4 int16": ("batch", 128, 1, False, (16, 0, 9), 0, 0),
    "B4 at L = 64": ("batch", 64, 1, True, (16, 0, 9), 2, 0),
}


@pytest.mark.parametrize("case", sorted(SLOT_CASES))
def test_exact_cell_launch_takes_s16x2_lanes_and_counts_slots(fake_lib, case):
    """An exact B1 or B4 launch passes k16 = 1 (the s16x2 kernel) and an
    int16 one its SAT; each counts
    in its mode's launches, and an exact one its slots by the route and
    the host's fit, from the matrix's noted range."""
    kind, L, scale, exact, rows, n16, n32 = SLOT_CASES[case]
    t = _meta((2, L, 32, 128), torch.int8)
    m = _meta_matrix(scale)
    if kind == "cell":
        fn, args = sw_cell.score_bucket_cell, (t, _meta(L, torch.int32), m,
                                                (rows[0], -11, -1, 16))
    else:
        fn, args = sw_cell.score_bucket_cell_batch, (t, _meta((len(rows), 48), torch.int32), m,
                                                      (0, -11, -1, 0, *rows))
    before = (fn.launches, fn.launches16, fn.s16x2_slots, fn.int32_slots)
    out = fn(*args, exact=exact)
    assert out.shape == ((2, 4096) if kind == "cell" else (len(rows), 2, 4096))
    assert (fn.launches, fn.launches16, fn.s16x2_slots, fn.int32_slots) == (
        before[0] + exact, before[1] + (not exact), before[2] + n16, before[3] + n32)
    (call,) = fake_lib.calls
    assert call[4:13] == (21, 2, L, 1 if kind == "cell" else len(rows),
                          rows[0] if kind == "cell" else 48, -11, -1,
                          *sw_cell.cell_shape(L))  # A, T, L, S, W, gop, gex, G, R
    assert call[13] == (1 if exact else sw_cell.SAT)  # k16
    assert (call[2] is None) == (kind == "cell")  # B4: the slots' row counts


def test_int32_kernel_names_launch_int32_lanes(fake_lib):
    """``launch_cell`` with an int32 kernel's name (the sweep's and the card
    tests' yardstick) passes k16 = 0 and counts its slots as int32."""
    fn = sw_cell.score_bucket_cell_batch
    before = (fn.s16x2_slots, fn.int32_slots)
    cuda_lib.launch_cell(fn, "sw_cell_batch_kernel", _meta((1, 64, 32, 128), torch.int8),
                         _meta((3, 16), torch.int32), _meta_matrix(), -11, -1, [16, 0, 3], (8, 8))
    assert fake_lib.calls[0][13] == 0
    assert (fn.s16x2_slots, fn.int32_slots) == (before[0], before[1] + 2)
