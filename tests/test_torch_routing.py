"""The per-query-length routing of single scans on the CPU against the JAX
engine: ``SearchEngine._single_kinds`` sends cell buckets whose L is a
multiple of LC to the col kernel for queries of COL_SINGLE_MIN_ROWS to
NQC unroll-padded rows (the JAX engine's rule).

The kinds themselves against the JAX engine's on the JAX test's pseudo
databases (tests/test_engine.py::test_col_routing_window); routed scans,
single-device and on a two-shard mesh, in exact and in int16 state (SAT
lowered to 30 in both packages, so that tiles flag and are re-scored),
with LC lowered to 16, NQC to 48 and the window opened at 16 in both
packages: the JAX engine's routed scan (its Pallas kernels in interpret
mode) and the port's unrouted scan give the port's routed results; and
``warmup``'s launches with the window open and closed, on "meta" tensors
with the launchers patched (no kernel runs).  Inputs are made with numpy
from seeds.  Tolerance: exact (scores, ids and order).
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

import cudasw4_tpu.db.packing as jp
from cudasw4_tpu import ops as jax_ops
from cudasw4_tpu.db.format import DBData as JaxDBData
from cudasw4_tpu.db.format import pseudo_to_dbdata as jax_pseudo_to_dbdata
from cudasw4_tpu.db.pseudo import make_pseudo_db as jax_make_pseudo_db
from cudasw4_tpu.engine import SearchEngine as JaxEngine
from cudasw4_tpu.ops import sw_pallas_cell, sw_pallas_col
from cudasw4_tpu.parallel import sharding as jsh
import cudasw4_tpu_torch.db.packing as tp
from cudasw4_tpu_torch.db.format import DBData, pseudo_to_dbdata
from cudasw4_tpu_torch.db.pseudo import make_pseudo_db
from cudasw4_tpu_torch.engine import SearchEngine
from cudasw4_tpu_torch.ops import cuda_lib, sw_cell, sw_col
from cudasw4_tpu_torch.parallel.sharding import make_mesh


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell_layout(mp):
    mp.setattr(jp, "CELL_SPEEDUP", 99.0)
    mp.setattr(tp, "CELL_SPEEDUP", 99.0)


# ------------------------------------------------------------- the kinds


@pytest.mark.parametrize("L", [120, 90])
@pytest.mark.parametrize("nq_pad", ["256", "512", "NQC", "NQC+8", "1024"])
def test_single_kinds_equal_jax(monkeypatch, L, nq_pad):
    """At the JAX default of 512: a one-pass query of 512 to NQC rows routes
    the cell bucket of L = 128 (10 x 120) to the col kernel; shorter ones,
    longer ones and a bucket of L = 96 (10 x 90, not a multiple of LC)
    stay on the cell kernel, in both engines."""
    _cell_layout(monkeypatch)
    monkeypatch.setattr(JaxEngine, "COL_SINGLE_MIN_ROWS", 512)
    monkeypatch.setattr(SearchEngine, "COL_SINGLE_MIN_ROWS", 512)
    jeng = JaxEngine(num_top=3, qcap=64, backend="pallas")
    jeng.set_database(jax_pseudo_to_dbdata(jax_make_pseudo_db(10, L)))
    eng = SearchEngine(num_top=3, qcap=64, device="cpu")
    eng.set_database(pseudo_to_dbdata(make_pseudo_db(10, L)))
    assert [(b.L, b.kernel) for b in eng.packed.buckets] == \
        [(b.L, b.kernel) for b in jeng.packed.buckets]
    assert sw_col.NQC == sw_pallas_col.NQC
    n = eval(nq_pad, {"NQC": sw_col.NQC})
    want = "col" if L == 120 and 512 <= n <= sw_col.NQC else "cell"
    assert eng._single_kinds(n) == jeng._single_kinds(n) == (want,)


# ---------------------------------------------------------- routed scans

#: Queries of 5, 20, 40 and 60 residues: 8 padded rows (below the window
#: of 16), 24 and 40 (routed), 64 (past NQC = 48).
QUERY_LENGTHS = (5, 20, 40, 60)


def _clear_jax():
    sw_pallas_cell.score_bucket_pallas_cell._clear_cache()
    sw_pallas_col.score_bucket_pallas_col._clear_cache()


@pytest.fixture
def routed(monkeypatch):
    """Cell layout, LC 16, NQC 48 and the window at 16 in both packages, the
    JAX Pallas kernels in interpret mode."""
    _cell_layout(monkeypatch)
    for mod in (sw_pallas_col, sw_col):
        monkeypatch.setattr(mod, "LC", 16)
        monkeypatch.setattr(mod, "NQC", 48)
    monkeypatch.setattr(JaxEngine, "COL_SINGLE_MIN_ROWS", 16)
    monkeypatch.setattr(SearchEngine, "COL_SINGLE_MIN_ROWS", 16)
    monkeypatch.setattr(jax_ops, "INTERPRET", True)
    _clear_jax()
    yield
    _clear_jax()


def _fields(rng):
    """A database of one cell tile of subjects of 5-32 residues (L = 32)
    and two of 33-48 (L = 48), both multiples of LC = 16."""
    lens = np.sort(np.concatenate([rng.integers(5, 33, 3000), rng.integers(33, 49, 5000)]))
    lens = lens.astype(np.int32)
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum((lens + 3) // 4 * 4, out=offsets[1:])
    chars = np.full(int(offsets[-1]), 20, np.int8)
    for a, n in zip(offsets[:-1], lens):
        chars[a : a + n] = rng.integers(0, 20, n)
    return dict(chars=chars, offsets=offsets.astype(np.uint64), lengths=lens,
                headers=np.zeros(0, np.uint8), header_offsets=np.zeros(len(lens) + 1, np.uint64))


def _results(rs):
    return [(r.scores, r.reference_ids, r.stats.num_overflows) for r in rs]


@pytest.mark.parametrize("state16", [False, True])
@pytest.mark.parametrize("shards", [1, 2])
def test_routed_scan_equals_jax_and_unrouted(routed, monkeypatch, shards, state16):
    rng = np.random.default_rng(77)
    fields = _fields(rng)
    queries = [rng.integers(0, 20, n).astype(np.int8) for n in QUERY_LENGTHS]
    if state16:
        for mod in (sw_pallas_cell, sw_pallas_col, sw_cell):
            monkeypatch.setattr(mod, "SAT", 30)
    jmesh = jsh.make_mesh(jax.devices()[:2]) if shards == 2 else None
    jeng = JaxEngine(num_top=8, qcap=64, backend="pallas", mesh=jmesh)
    jeng.state16 = state16
    jeng.set_database(JaxDBData(**fields))
    assert [jeng._single_kinds(n) for n in (8, 24, 64)] == \
        [("cell", "cell"), ("col", "col"), ("cell", "cell")]
    want = _results(map(jeng.scan, queries))

    mesh = make_mesh(["cpu"] * 2) if shards == 2 else None
    eng = SearchEngine(num_top=8, qcap=64, device="cpu", mesh=mesh)
    eng.state16 = state16
    eng.set_database(DBData(**fields))
    assert [(b.L, b.kernel, b.num_tiles) for b in eng.packed.buckets] == \
        [(32, "cell", 1), (48, "cell", 2)]
    calls = "plain_calls16" if state16 else "plain_calls"
    before = getattr(sw_col.score_bucket_col, calls)
    got = _results(map(eng.scan, queries))
    # two routed queries, each on both buckets of every shard that holds
    # tiles of them
    holders = 2 if shards == 1 else 3
    assert getattr(sw_col.score_bucket_col, calls) - before == 2 * holders
    assert got == want
    if state16:
        assert sum(r[2] for r in got) > 0  # tiles flagged and re-scored
    eng.COL_SINGLE_MIN_ROWS = sw_col.NQC + 1
    assert _results(map(eng.scan, queries)) == want


# ---------------------------------------------------------------- warmup


def _meta_engine(monkeypatch, launches):
    """A CPU engine on a pseudo database of one cell bucket (L = 128),
    then turned into a card's: its tiles and matrix on "meta" tensors, the
    launchers patched to count each launch on ``launches`` by (kernel,
    state) and return zero scores on the CPU, the synchronisation a
    no-op."""
    _cell_layout(monkeypatch)
    eng = SearchEngine(num_top=3, device="cpu")
    eng.set_database(pseudo_to_dbdata(make_pseudo_db(10, 120)))
    assert [(b.L, b.kernel) for b in eng.packed.buckets] == [(128, "cell")]

    def record(wrapper, kernel, tiles, queries, sat):
        launches.append((kernel, "int16" if sat else "int32"))
        cuda_lib.count(wrapper, not sat)
        return torch.zeros((queries.shape[0], tiles.shape[0], 4096))

    def fake_cell(wrapper, kernel, tiles, queries, matrix_flat, gop, gex, rows, shape, sat=0):
        return record(wrapper, kernel, tiles, queries, sat)

    def fake_col(wrapper, kernel, tiles, queries, matrix_flat, gop, gex, sat=0, **kw):
        return record(wrapper, kernel, tiles, queries, sat), None

    monkeypatch.setattr(cuda_lib, "launch_cell", fake_cell)
    monkeypatch.setattr(cuda_lib, "launch_col", fake_col)
    monkeypatch.setattr(cuda_lib, "to_device", lambda a, dev: torch.as_tensor(a).to("meta"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: None)
    monkeypatch.setattr(eng, "device", torch.device("cuda"))
    monkeypatch.setattr(eng, "_bucket_tiles", [t.to("meta") for t in eng._bucket_tiles])
    monkeypatch.setattr(eng, "_matrix_flat", eng._matrix_flat.to("meta"))
    return eng


@pytest.mark.parametrize("state16", [False, True])
@pytest.mark.parametrize("window", [512, "closed"])
def test_warmup_launches_routed_col(monkeypatch, window, state16):
    """warmup() at the minimal query: B1 on the cell bucket, in s16x2
    lanes (and B1 int16 under state16); with the window open also B3 on it
    (and B3 int16), as the JAX warmup runs
    ``_single_kinds(COL_SINGLE_MIN_ROWS)``; returns the launches."""
    launches = []
    eng = _meta_engine(monkeypatch, launches)
    eng.state16 = state16
    eng.COL_SINGLE_MIN_ROWS = sw_col.NQC + 1 if window == "closed" else window
    n = eng.warmup()
    want = [("sw_cell16_kernel", "int32")] + [("sw_cell_kernel", "int16")] * state16
    if window != "closed":
        want += [("sw_col_kernel", "int32")] + [("sw_col_kernel", "int16")] * state16
    assert launches == want
    assert n == len(want)
