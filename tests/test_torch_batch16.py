"""The int16 modes of the port's batch kernels on the CPU against the JAX
package, and the ported ``colstate16`` tool.

The plain versions of B4 (cell batch), B5 (col flat) and B6 (col fused)
with ``exact=False`` against the Pallas kernels with ``exact=False`` in
interpret mode (col tests lower LC to 16 in both packages, as
tests/test_torch_batch.py does), under the SAT rule
(``sw_cell.sat_match``): at SAT lowered to 30 in both packages, where some
subjects saturate, and at the default SAT, where the scores equal the
exact ones (each SAT at its own shapes: JAX keeps traced Pallas kernels
past ``_clear_cache``, keyed by shape).  Then the wrappers' launch
arguments on a "meta" tensor (no kernel runs): ``sat`` > 0 reaches the
launchers and the col launch allocates an int16 boundary pool.  Then the
ported ``colstate16`` body at L = 32, queries of 16-32 rows and T = 1: its
scores in both modes equal the JAX kernels' (B3 and B5, interpret mode) on
the same inputs.  Inputs are made with numpy from seeds.
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudasw4_tpu import make_scoring_config as jax_scoring
from cudasw4_tpu.ops import sw_pallas_cell, sw_pallas_col
from cudasw4_tpu_torch.ops import cuda_lib, sw_cell, sw_col
from cudasw4_tpu_torch.tools import colstate16

MATS = ["blosum62", "blosum62_full"]
SATS = [30, 32000]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clear_jax():
    for fn in (sw_pallas_cell.score_bucket_pallas_cell_batch,
               sw_pallas_col.score_bucket_pallas_col,
               sw_pallas_col.score_bucket_pallas_col_flat,
               sw_pallas_col.score_bucket_pallas_col_flat_fused):
        fn._clear_cache()


@pytest.fixture
def sat(request, monkeypatch):
    """SAT in both packages (the col module holds its own copy)."""
    for mod in (sw_pallas_cell, sw_pallas_col, sw_cell):
        monkeypatch.setattr(mod, "SAT", request.param)
    _clear_jax()
    yield request.param
    _clear_jax()


@pytest.fixture
def col_geometry(monkeypatch):
    monkeypatch.setattr(sw_pallas_col, "LC", 16)
    monkeypatch.setattr(sw_col, "LC", 16)


def _tiles(rng, shape, pad, A):
    """Subject codes in [0, A-1) with ragged lengths; pad past each;
    subject 5 of tile 0 full length."""
    T, L = shape[0], shape[1]
    x = rng.integers(0, A - 1, size=(T, L, 4096)).astype(np.int8)
    lens = rng.integers(1, L + 1, size=(T, 1, 4096))
    x[np.arange(L)[None, :, None] >= lens] = pad
    x[0, :, 5] = rng.integers(0, A - 1, size=L)
    return np.ascontiguousarray(x.reshape(shape))


def _slots(rng, lengths, W, pad, A, tiles):
    """Query slots of ``lengths`` codes, padded to W; the longest slot's
    first 16 codes match subject 5 of tile 0 (a score of at least 16)."""
    q = np.full((len(lengths), W), pad, np.int32)
    for s, n in enumerate(lengths):
        q[s, :n] = rng.integers(0, A - 1, size=n)
    s = int(np.argmax(lengths))
    q[s, :16] = tiles.reshape(tiles.shape[0], tiles.shape[1], 4096)[0, :16, 5]
    return q


def _args(tiles, q, cfg, rows):
    mat = cfg.matrix.astype(np.int32).reshape(-1)
    params = np.array([0, cfg.gop, cfg.gex, 0, *rows], np.int32)
    jargs = tuple(map(jnp.asarray, (tiles, q, mat, params)))
    targs = (torch.as_tensor(tiles), torch.as_tensor(q), torch.as_tensor(mat), params)
    return jargs, targs


def _check_sat_rule(got, want, exact, sat):
    assert bool(sw_cell.sat_match(got, want).all())
    assert bool(sw_cell.sat_match(got, exact).all())
    if sat == 30:
        assert int((exact >= 30).sum()) >= 1 and int((got >= 30).sum()) >= 1
    else:
        assert torch.equal(got, exact)


# ------------------------------------------------------------- kernels


@pytest.mark.parametrize("sat", SATS, indirect=True)
@pytest.mark.parametrize("mat", MATS)
def test_cell_batch16_plain_meets_sat_rule_against_pallas(sat, mat):
    """B4 int16: four slots (one empty, lengths no multiple of 8)."""
    rng = np.random.default_rng(81)
    cfg = jax_scoring(mat)
    A, pad = cfg.alphabet_size, cfg.pad_code
    L = 24 if sat == 30 else 40
    tiles = _tiles(rng, (1, L, 32, 128), pad, A)
    nqs = [13, 0, 30, 7]
    q = _slots(rng, nqs, 32, pad, A, tiles)
    jargs, targs = _args(tiles, q, cfg, nqs)
    want = torch.as_tensor(np.asarray(sw_pallas_cell.score_bucket_pallas_cell_batch(
        *jargs, interpret=True, unroll=8, exact=False)))
    exact = torch.as_tensor(np.asarray(sw_pallas_cell.score_bucket_pallas_cell_batch(
        *jargs, interpret=True, unroll=8, exact=True)))
    fn = sw_cell.score_bucket_cell_batch
    before = (fn.plain_calls, fn.plain_calls16)
    got = fn(*targs, exact=False)
    assert (fn.plain_calls, fn.plain_calls16) == (before[0], before[1] + 1)
    assert got.shape == (4, 1, 4096) and not got[1].any()
    _check_sat_rule(got, want, exact, sat)


@pytest.mark.parametrize("sat", SATS, indirect=True)
@pytest.mark.parametrize("mat", MATS)
def test_col_flat16_and_fused16_plain_meet_sat_rule_against_pallas(col_geometry, sat, mat):
    """B5 and B6 int16 at LC = 16, rtot = 128: three slots, real lengths
    below the padded row counts (pad rows walked)."""
    rng = np.random.default_rng(82)
    cfg = jax_scoring(mat)
    A, pad = cfg.alphabet_size, cfg.pad_code
    L = 32 if sat == 30 else 48
    nqps, offs = (8, 32, 24), (0, 32, 96)
    tiles = _tiles(rng, (1, L, 32, 128), pad, A)
    q = _slots(rng, [5, 30, 21], 32, pad, A, tiles)
    jargs, targs = _args(tiles, q, cfg, nqps)
    runs = {}
    for name, jfn, tfn, kw in (
        ("flat", sw_pallas_col.score_bucket_pallas_col_flat, sw_col.score_bucket_col_flat,
         {"offs": offs}),
        ("fused", sw_pallas_col.score_bucket_pallas_col_flat_fused,
         sw_col.score_bucket_col_flat_fused, {}),
    ):
        want = torch.as_tensor(np.asarray(jfn(*jargs, rtot=128, interpret=True, unroll=8,
                                              exact=False, **kw)))
        exact = torch.as_tensor(np.asarray(jfn(*jargs, rtot=128, interpret=True, unroll=8,
                                               exact=True, **kw)))
        before = (tfn.plain_calls, tfn.plain_calls16)
        got = tfn(*targs, rtot=128, exact=False, **kw)
        assert (tfn.plain_calls, tfn.plain_calls16) == (before[0], before[1] + 1)
        _check_sat_rule(got, want, exact, sat)
        runs[name] = got
    assert torch.equal(runs["flat"], runs["fused"])


# ------------------------------------------------- launch arguments


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("L,launcher,kernel", [
    (256, "launch_cell", "sw_cell_batch_kernel"),
    (896, "launch_col", "sw_col_flat_kernel"),
])
def test_cell_batch16_passes_sat_to_its_launcher(monkeypatch, L, launcher, kernel):
    """B4 int16 on a device tensor: the cell route up to the largest
    instance, the col flat route past it, each with sat = SAT."""
    calls = []

    def fake(wrapper, name, tiles, queries, matrix_flat, gop, gex, *args, **kw):
        calls.append((wrapper, name, args, kw))
        out = torch.zeros((queries.shape[0], tiles.shape[0], 4096))
        return (out, None) if launcher == "launch_col" else out

    monkeypatch.setattr(cuda_lib, launcher, fake)
    nqs = (16, 0, 9)
    t, q, m = _meta((1, L, 32, 128), torch.int8), _meta((3, 32), torch.int32), _meta(441, torch.int32)
    got = sw_cell.score_bucket_cell_batch(t, q, m, (0, -11, -1, 0, *nqs), exact=False)
    assert got.shape == (3, 1, 4096)
    ((wrapper, name, args, kw),) = calls
    assert (wrapper, name) == (sw_cell.score_bucket_cell_batch, kernel)
    if launcher == "launch_cell":
        assert args == (list(nqs), sw_cell.cell_shape(L), sw_cell.SAT)
    else:
        assert kw == {"slots": (list(nqs), [0, 16, 16], 32), "sat": sw_cell.SAT}


def test_col_flat16_and_fused16_pass_sat_to_launch_col(monkeypatch):
    calls = []

    def fake(wrapper, kernel, tiles, queries, matrix_flat, gop, gex, slots=None, **kw):
        calls.append((wrapper, kernel, slots, kw))
        return torch.zeros((queries.shape[0], tiles.shape[0], 4096)), None

    monkeypatch.setattr(cuda_lib, "launch_col", fake)
    nqps = (16, 0, 8)
    t, q, m = _meta((1, 1152, 32, 128), torch.int8), _meta((3, 64), torch.int32), _meta(441, torch.int32)
    p = (0, -11, -1, 0, *nqps)
    sw_col.score_bucket_col_flat(t, q, m, p, (0, 128, 256), rtot=384, exact=False)
    sw_col.score_bucket_col_flat_fused(t, q, m, p, rtot=384, exact=False)
    sw_col.score_bucket_col_flat_fused(t, q, m, p, rtot=384)
    assert calls == [
        (sw_col.score_bucket_col_flat, "sw_col_flat_kernel", ([16, 0, 8], (0, 128, 256), 384),
         {"sat": sw_cell.SAT, "lengths": None}),
        (sw_col.score_bucket_col_flat_fused, "sw_col_fused_kernel", (None, [0, 16, 16, 24], 24),
         {"sat": sw_cell.SAT, "lengths": None}),
        (sw_col.score_bucket_col_flat_fused, "sw_col_fused_kernel", (None, [0, 16, 16, 24], 24),
         {"sat": 0, "lengths": None}),
    ]


class _FakeLib:
    """The kernel library's launch functions, recording their arguments."""

    def __init__(self):
        self.calls = []

    def sw_col_pass_columns(self):
        return 512

    def sw_col_launch(self, *args):
        self.calls.append(("col", args))
        return 0

    def sw_cell_launch(self, *args):
        self.calls.append(("cell", args))
        return 0


@pytest.mark.parametrize("exact", [True, False])
def test_launch_col_allocates_an_int16_pool_under_sat(monkeypatch, exact):
    """``launch_col`` on a device tensor past one pass: boundary columns
    [T * 4096, rtot] of int16 under sat (int32 exact), sat passed to the
    library, and the launch counted on the mode's counter."""
    fake = _FakeLib()
    pools = []
    real_empty = torch.empty

    def spy_empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        pools.append((tuple(t.shape), t.dtype))
        return t

    monkeypatch.setattr(cuda_lib, "lib", lambda: fake)
    monkeypatch.setattr(cuda_lib, "stream_handle", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch, "empty", spy_empty)
    t, q, m = _meta((2, 1024, 32, 128), torch.int8), _meta((2, 48), torch.int32), _meta(441, torch.int32)
    p = (0, -11, -1, 0, 48, 16)
    fn = sw_col.score_bucket_col_flat
    before = (fn.launches, fn.launches16)
    out = fn(t, q, m, p, (0, 64), rtot=128, exact=exact)
    assert out.shape == (2, 2, 4096)
    assert (fn.launches, fn.launches16) == (before[0] + exact, before[1] + (not exact))
    pool_dtype = torch.int32 if exact else torch.int16
    assert ((2 * 4096, 128), pool_dtype) in pools  # H (E is made like it)
    ((kind, args),) = fake.calls
    assert kind == "col" and args[20] == (0 if exact else sw_cell.SAT)  # sat
    assert args[5:13] == (21, 2, 1024, 2, 48, 128, -11, -1)  # A, T, L, S, W, rtot, gop, gex

    # B4 int16 on the cell route: rows and sat reach sw_cell_launch.
    fake.calls.clear()
    fn = sw_cell.score_bucket_cell_batch
    before = fn.launches16
    t = _meta((2, 640, 32, 128), torch.int8)
    fn(t, q, m, (0, -11, -1, 0, 40, 0), exact=False)
    ((kind, args),) = fake.calls
    assert kind == "cell" and args[2] is not None  # the slots' row counts
    assert args[4:14] == (21, 2, 640, 2, 48, -11, -1, 32, 20, sw_cell.SAT)
    assert fn.launches16 == before + 1


# --------------------------------------------------------- colstate16


@pytest.fixture
def tool_geometry(monkeypatch):
    """LC 16 and NQC 128 in both packages, the flat pool's offsets 32
    apart: colstate16's body at L = 32."""
    for mod in (sw_pallas_col, sw_col):
        monkeypatch.setattr(mod, "LC", 16)
        monkeypatch.setattr(mod, "NQC", 128)
    monkeypatch.setattr(sw_col, "FLAT_QUANT", 32)
    _clear_jax()
    yield
    _clear_jax()


def test_colstate16_body_equals_pallas(tool_geometry):
    """Both modes of each line equal the JAX kernels (B3, B5) on the same
    inputs; every line says OK."""
    seen = []

    def inspect(line, inputs, scores):
        seen.append((line["kind"], inputs, scores))

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lines = colstate16.run(1, 1, torch.device("cpu"), lengths=(32,), query_lengths=(16, 32),
                               slot_sets=((16, 24), (32, 16, 8)), inspect=inspect)
    printed = buf.getvalue().splitlines()
    assert [x["kind"] for x in lines] == ["single", "single", "flat", "flat"]
    assert [kind for kind, _, _ in seen] == [x["kind"] for x in lines]
    assert [p.split(":")[0] for p in printed] == [
        "single L=32 q=16", "single L=32 q=32", "flat  L=32 slots=[16, 24]",
        "flat  L=32 slots=[32, 16, 8]"]
    assert all(p.endswith("[OK]") and "GCUPS" in p for p in printed)
    assert seen[2][1]["offs"] == (0, 32) and seen[3][1]["offs"] == (0, 32, 64)
    mat = jnp.asarray(jax_scoring("blosum62").matrix.astype(np.int32).reshape(-1))
    for x, (kind, inputs, scores) in zip(lines, seen):
        assert x["ok"] and x["max_diff"] == 0.0
        assert torch.equal(scores["i16"], scores["i32"])
        assert np.array_equal(inputs["matrix"].numpy(), np.asarray(mat))
        tiles = jnp.asarray(inputs["tiles"].numpy())
        q = jnp.asarray(inputs["queries"].numpy())
        params = jnp.asarray(np.array(inputs["params"], np.int32))
        for exact, mode in ((True, "i32"), (False, "i16")):
            if kind == "single":
                want = sw_pallas_col.score_bucket_pallas_col(
                    tiles, q, mat, params, interpret=True, exact=exact)
            else:
                want = sw_pallas_col.score_bucket_pallas_col_flat(
                    tiles, q, mat, params, offs=inputs["offs"], rtot=inputs["rtot"],
                    interpret=True, exact=exact)
            assert np.array_equal(scores[mode].numpy(), np.asarray(want)), (kind, mode)


def test_colstate16_main_on_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        with pytest.raises(SystemExit):
            colstate16.main(["1", "x"])
    # Device defaults to CUDA: without a card it refuses rather than run
    # the plain versions.
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            colstate16.main(["1", "1"])
    assert colstate16.parse_argv(["2", "5", "--device", "cpu"]) == (2, 5, torch.device("cpu"))
    assert colstate16.parse_argv(["--device", "cpu"]) == (64, 3, torch.device("cpu"))
