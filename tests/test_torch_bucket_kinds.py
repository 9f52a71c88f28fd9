"""Single scans run every bucket on its own kind, for every query length.

The JAX engine routes a single query of its window's rows (512 by
default) to NQC unroll-padded rows onto its col kernel on cell buckets
whose L is a multiple of LC.  On an H100 that routing lost at every
threshold, so the port has none.  Here, against the JAX engine on the CPU:
- at the query lengths where the JAX engine's window (512) routes a cell
  bucket, the port's single scan still launches the cell kernel (B1) on
  it and the col kernel (B3) only on col buckets, on "meta" tiles with
  the launchers patched (no kernel runs);
- the port's scans equal the JAX engine's scans with its window open (at
  16) and closed, single-device and on a two-shard mesh, in exact and in
  int16 state (SAT lowered to 30 in both packages, so that tiles flag and
  are re-scored), with LC lowered to 16 and NQC to 48 in both packages
  and the JAX Pallas kernels in interpret mode;
- ``warmup`` launches each bucket's own kernel once, in each state mode.
Inputs are made with numpy from seeds.  Tolerance: exact (scores, ids and
order).
"""

import jax
import numpy as np
import pytest
import torch

import cudasw4_tpu.db.packing as jp
from cudasw4_tpu import ops as jax_ops
from cudasw4_tpu.db.format import DBData as JaxDBData
from cudasw4_tpu.engine import SearchEngine as JaxEngine
from cudasw4_tpu.ops import sw_pallas_cell, sw_pallas_col
from cudasw4_tpu.parallel import sharding as jsh
import cudasw4_tpu_torch.db.packing as tp
from cudasw4_tpu_torch.db.format import DBData
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


def _layouts(mp):
    """Small subject counts take the cell layout up to CELL_MAX_L and the
    col layout past it, in both packages."""
    for mod in (jp, tp):
        mp.setattr(mod, "CELL_SPEEDUP", 99.0)
        mp.setattr(mod, "COL_SPEEDUP", 99.0)


def _fields(rng, groups):
    """DB fields of subjects of uniform random lengths in each (lo, hi,
    count) of ``groups``, sorted by length, random codes."""
    lens = np.sort(np.concatenate([rng.integers(lo, hi + 1, n) for lo, hi, n in groups]))
    lens = lens.astype(np.int32)
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum((lens + 3) // 4 * 4, out=offsets[1:])
    chars = np.full(int(offsets[-1]), 20, np.int8)
    for a, n in zip(offsets[:-1], lens):
        chars[a : a + n] = rng.integers(0, 20, n)
    return dict(chars=chars, offsets=offsets.astype(np.uint64), lengths=lens,
                headers=np.zeros(0, np.uint8), header_offsets=np.zeros(len(lens) + 1, np.uint64))


def _meta_engine(monkeypatch, fields, launches):
    """A CPU engine on ``fields``, then turned into a card's: its tiles and
    matrix on "meta" tensors, the launchers patched to record each launch
    on ``launches`` as (kernel, state, the tiles' L) and return zero
    scores on the CPU, the synchronisation and the NVTX ranges no-ops."""
    eng = SearchEngine(num_top=3, device="cpu")
    eng.set_database(DBData(**fields))

    def record(wrapper, kernel, tiles, queries, sat):
        launches.append((kernel, "int16" if sat else "int32", tiles.shape[1]))
        cuda_lib.count(wrapper, not sat)
        return torch.zeros((queries.shape[0], tiles.shape[0], 4096))

    def fake_cell(wrapper, tiles, queries, matrix_flat, gop, gex, rows, shape, sat=0):
        return record(wrapper, "sw_cell16_kernel", tiles, queries, sat)

    def fake_col(wrapper, kernel, tiles, queries, matrix_flat, gop, gex, sat=0, **kw):
        return record(wrapper, kernel, tiles, queries, sat), None

    monkeypatch.setattr(cuda_lib, "launch_cell", fake_cell)
    monkeypatch.setattr(cuda_lib, "launch_col", fake_col)
    monkeypatch.setattr(cuda_lib, "to_device", lambda a, dev: torch.as_tensor(a).to("meta"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: None)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda name: None)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: None)
    monkeypatch.setattr(eng, "device", torch.device("cuda"))
    monkeypatch.setattr(eng, "_bucket_tiles", [t.to("meta") for t in eng._bucket_tiles])
    monkeypatch.setattr(eng, "_matrix_flat", eng._matrix_flat.to("meta"))
    return eng


# ------------------------------------------------ kinds at every length


@pytest.mark.parametrize("L", [120, 90])
@pytest.mark.parametrize("nq_pad", ["256", "512", "NQC", "NQC+8", "1024"])
def test_single_scan_runs_each_bucket_on_its_own_kind(monkeypatch, L, nq_pad):
    """A cell bucket of L = 128 (subjects of 120 residues; a multiple of
    LC) or of L = 96 (of 90; not one) and a col bucket: at its default window
    of 512 the JAX engine routes the L = 128 bucket to the col kernel for
    queries of 512 to NQC rows.  The port's single scan launches B1 once
    on the cell bucket and B3 only on the col bucket (twice, with the
    carry, past NQC) at every length."""
    _layouts(monkeypatch)
    monkeypatch.setattr(JaxEngine, "COL_SINGLE_MIN_ROWS", 512)
    fields = _fields(np.random.default_rng(5), [(L, L, 10), (850, 850, 10)])
    n = eval(nq_pad, {"NQC": sw_col.NQC})
    launches = []
    eng = _meta_engine(monkeypatch, fields, launches)
    jeng = JaxEngine(num_top=3, backend="pallas")
    jeng.set_database(JaxDBData(**fields))
    kinds = [(b.L, b.kernel) for b in eng.packed.buckets]
    assert kinds == [(b.L, b.kernel) for b in jeng.packed.buckets]
    (cell_L, _), (col_L, _) = kinds
    assert [k for _, k in kinds] == ["cell", "col"] and cell_L == (128 if L == 120 else 96)
    assert sw_col.NQC == sw_pallas_col.NQC and sw_col.LC == sw_pallas_col.LC
    routes = L == 120 and 512 <= n <= sw_col.NQC
    assert jeng._single_kinds(n) == ("col" if routes else "cell", "col")

    eng.scan(np.random.default_rng(6).integers(0, 20, n).astype(np.int8))
    chunks = -(-n // sw_col.NQC)
    assert launches == [("sw_cell16_kernel", "int32", cell_L)] + \
        [("sw_col_kernel", "int32", col_L)] * chunks


# ------------------------------------------------- scans against JAX's

#: Queries of 5, 20, 40 and 60 residues: 8 padded rows (below the JAX
#: window of 16), 24 and 40 (routed there), 64 (past NQC = 48).
QUERY_LENGTHS = (5, 20, 40, 60)


def _clear_jax():
    sw_pallas_cell.score_bucket_pallas_cell._clear_cache()
    sw_pallas_col.score_bucket_pallas_col._clear_cache()


@pytest.fixture
def small_col(monkeypatch):
    """Cell layout, LC 16 and NQC 48 in both packages, the JAX Pallas
    kernels in interpret mode."""
    _layouts(monkeypatch)
    for mod in (sw_pallas_col, sw_col):
        monkeypatch.setattr(mod, "LC", 16)
        monkeypatch.setattr(mod, "NQC", 48)
    monkeypatch.setattr(jax_ops, "INTERPRET", True)
    _clear_jax()
    yield
    _clear_jax()


def _results(rs):
    return [(r.scores, r.reference_ids, r.stats.num_overflows) for r in rs]


@pytest.mark.parametrize("window", [16, "closed"])
@pytest.mark.parametrize("state16", [False, True])
@pytest.mark.parametrize("shards", [1, 2])
def test_single_scan_equals_jax_routed_and_unrouted(small_col, monkeypatch, shards, state16,
                                                    window):
    """One cell tile of subjects of 5-32 residues (L = 32) and two of 33-48
    (L = 48), both multiples of LC = 16: the JAX engine's scans with its
    window at 16 (the queries of 24 and 40 rows routed to its col kernel)
    or closed equal the port's, which launch the col kernel on neither
    bucket."""
    rng = np.random.default_rng(77)
    fields = _fields(rng, [(5, 32, 3000), (33, 48, 5000)])
    queries = [rng.integers(0, 20, n).astype(np.int8) for n in QUERY_LENGTHS]
    if state16:
        for mod in (sw_pallas_cell, sw_pallas_col, sw_cell):
            monkeypatch.setattr(mod, "SAT", 30)
    monkeypatch.setattr(JaxEngine, "COL_SINGLE_MIN_ROWS",
                        sw_col.NQC + 1 if window == "closed" else window)
    jmesh = jsh.make_mesh(jax.devices()[:2]) if shards == 2 else None
    jeng = JaxEngine(num_top=8, qcap=64, backend="pallas", mesh=jmesh)
    jeng.state16 = state16
    jeng.set_database(JaxDBData(**fields))
    routed = ("col", "col") if window == 16 else ("cell", "cell")
    assert [jeng._single_kinds(n) for n in (8, 24, 64)] == \
        [("cell", "cell"), routed, ("cell", "cell")]
    want = _results(map(jeng.scan, queries))

    mesh = make_mesh(["cpu"] * 2) if shards == 2 else None
    eng = SearchEngine(num_top=8, qcap=64, device="cpu", mesh=mesh)
    eng.state16 = state16
    eng.set_database(DBData(**fields))
    assert [(b.L, b.kernel, b.num_tiles) for b in eng.packed.buckets] == \
        [(32, "cell", 1), (48, "cell", 2)]
    col = sw_col.score_bucket_col
    before = (col.plain_calls, col.plain_calls16)
    assert _results(map(eng.scan, queries)) == want
    assert (col.plain_calls, col.plain_calls16) == before
    if state16:
        assert sum(r[2] for r in want) > 0  # tiles flagged and re-scored


# ---------------------------------------------------------------- warmup


@pytest.mark.parametrize("state16", [False, True])
def test_warmup_launches_each_bucket_kind_once(monkeypatch, state16):
    """warmup() at the minimal query on a cell bucket (L = 128, a multiple
    of LC) and a col bucket: B1 on the cell bucket and B3 on the col
    bucket, each once (and once in int16 state under state16), then the
    carry variants on the col bucket alone; returns the launches."""
    _layouts(monkeypatch)
    fields = _fields(np.random.default_rng(5), [(120, 120, 10), (850, 850, 10)])
    launches = []
    eng = _meta_engine(monkeypatch, fields, launches)
    eng.state16 = state16
    carried = []
    monkeypatch.setattr(eng, "_warmup_col_chunked",
                        lambda tiles, lengths: carried.append(tiles.shape[1]))
    n = eng.warmup()
    (cell_L, _), (col_L, _) = [(b.L, b.kernel) for b in eng.packed.buckets]
    states = ("int32", "int16") if state16 else ("int32",)
    want = [("sw_cell16_kernel", s, cell_L) for s in states] + \
        [("sw_col_kernel", s, col_L) for s in states]
    assert launches == want
    assert carried == [col_L]
    assert n == len(want)
