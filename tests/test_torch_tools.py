"""The port's experiment kernels and tools on the CPU against the JAX
package: the manual-staging cell kernel (B7) against
``score_bucket_pallas_cell_manual`` in interpret mode, in both state
modes (SAT lowered to 30 for int16, under the SAT rule); the P-tiles-per-
block kernel (B8, ``tools.pairbench.score_pair``) against the cell kernel
in interpret mode (JAX's ``score_pair`` has no interpret mode, and
pairbench itself checks against the cell kernel); and both tools' ``main``
at L = 32, n = 8192.  The engine tools' bodies at tiny sizes: bigsingle
(B1 against B3 on the same tiles, LC 16 and NQC 24 so that the longer
query chunks with the carry), sweepdiag, and tremblbench, which must
stream under a tiny budget and give a resident scan's hits on a database
equal to the JAX tools/dbbench.py's.  The colpass tool's tile: the last of
the largest col bucket of the benchmark's Swiss-Prot-scale lengths.  Inputs are made with numpy from
seeds.
"""

import contextlib
import importlib.util
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudasw4_tpu import make_scoring_config as jax_scoring
from cudasw4_tpu.ops import sw_pallas_cell
from cudasw4_tpu_torch.engine import SearchEngine
from cudasw4_tpu_torch.engine_streaming import STREAM_CHUNK_BYTES
from cudasw4_tpu_torch.ops import sw_cell, sw_col
from cudasw4_tpu_torch.tools import bigsingle, colpass, dmabench, pairbench, sweepdiag, tremblbench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, T, L, nq, mat="blosum62"):
    rng = np.random.default_rng(seed)
    cfg = jax_scoring(mat)
    A, pad = cfg.alphabet_size, cfg.pad_code
    x = rng.integers(0, A - 1, size=(T, L, 4096)).astype(np.int8)
    lens = rng.integers(1, L + 1, size=(T, 1, 4096))
    x[np.arange(L)[None, :, None] >= lens] = pad
    tiles = np.ascontiguousarray(x.reshape(T, L, 32, 128))
    q = np.full(64, pad, np.int32)
    q[:nq] = rng.integers(0, A - 1, size=nq)
    params = np.array([nq, cfg.gop, cfg.gex, 0], np.int32)
    mat_flat = cfg.matrix.astype(np.int32).reshape(-1)
    jargs = tuple(map(jnp.asarray, (tiles, q, mat_flat, params)))
    targs = (torch.as_tensor(tiles), torch.as_tensor(q), torch.as_tensor(mat_flat), params)
    return jargs, targs


@pytest.mark.parametrize("exact", [True, False])
def test_manual_plain_equals_pallas_manual(exact, monkeypatch):
    sat = sw_cell.SAT if exact else 30
    monkeypatch.setattr(sw_pallas_cell, "SAT", sat)
    monkeypatch.setattr(sw_cell, "SAT", sat)
    sw_pallas_cell.score_bucket_pallas_cell_manual._clear_cache()
    # Each mode at its own L: traced Pallas kernels outlive _clear_cache.
    jargs, targs = _inputs(71, 3, 16 if exact else 24, 12)
    want = torch.as_tensor(np.asarray(sw_pallas_cell.score_bucket_pallas_cell_manual(
        *jargs, interpret=True, exact=exact)))
    before = (sw_cell.score_bucket_cell_manual.plain_calls,
              sw_cell.score_bucket_cell_manual.plain_calls16)
    got = sw_cell.score_bucket_cell_manual(*targs, exact=exact)
    after = (sw_cell.score_bucket_cell_manual.plain_calls,
             sw_cell.score_bucket_cell_manual.plain_calls16)
    assert after == (before[0] + exact, before[1] + (not exact))
    if exact:
        assert torch.equal(got, want)
    else:
        assert bool(sw_cell.sat_match(got, want).all())
        assert int((want >= 30).sum()) > 0
    sw_pallas_cell.score_bucket_pallas_cell_manual._clear_cache()


def test_manual_rejects_non_cell_tiles():
    _, (tiles, q, mat, params) = _inputs(73, 2, 8, 5)
    before = sw_cell.score_bucket_cell_manual.plain_calls
    with pytest.raises(ValueError):
        sw_cell.score_bucket_cell_manual(tiles.reshape(2, 8, 4096), q, mat, params)
    with pytest.raises(ValueError):
        sw_cell.score_bucket_cell_manual(tiles.reshape(2, 8, 64, 64), q, mat, params)
    assert sw_cell.score_bucket_cell_manual.plain_calls == before


@pytest.mark.parametrize("P", [2, 4])
def test_pair_plain_equals_pallas_cell(P):
    jargs, targs = _inputs(72, 4, 16, 20, "blosum62_full")
    want = torch.as_tensor(np.asarray(sw_pallas_cell.score_bucket_pallas_cell(
        *jargs, interpret=True, exact=True)))
    before = pairbench.score_pair.plain_calls
    got = pairbench.score_pair(*targs, P=P)
    assert pairbench.score_pair.plain_calls == before + 1
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        pairbench.score_pair(targs[0][:3], *targs[1:], P=P)


@pytest.mark.parametrize("tool,checks", [(dmabench, 3), (pairbench, 2)])
def test_tool_main_prints_only_ok(tool, checks):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tool.main(["32", "8192", "1", "--device", "cpu"]) == 0
    lines = buf.getvalue().splitlines()
    assert sum("[OK]" in line for line in lines) == checks
    assert not any("MISMATCH" in line for line in lines)
    assert all("GCUPS" in line or "skipped" in line for line in lines)


# ------------------------------------------------------- engine tools


def _load(relpath):
    """A module of the repository by path (the root tools/ and
    benchmarks/ are not packages)."""
    spec = importlib.util.spec_from_file_location(os.path.basename(relpath)[:-3],
                                                  os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bigsingle_body_on_cpu(monkeypatch, capsys):
    """Both routes on one tile of subjects of 32 residues, queries of 8 and
    40 rows (two chunks with the carry at NQC = 24), both states: four
    lines, each OK, and each route's plain version called once a line and
    mode besides the warm-up."""
    monkeypatch.setattr(sw_col, "LC", 16)
    monkeypatch.setattr(sw_col, "NQC", 24)
    counters = [(fn, name) for fn in (sw_cell.score_bucket_cell, sw_col.score_bucket_col)
                for name in ("plain_calls", "plain_calls16")]
    before = [getattr(fn, name) for fn, name in counters]
    lines = bigsingle.run(1, 1, torch.device("cpu"), lengths=(32,), query_lengths=(8, 40))
    calls = [getattr(fn, name) - b for (fn, name), b in zip(counters, before)]
    assert [(x["q"], x["state"], x["ok"]) for x in lines] == [
        (8, "i32", True), (8, "i16", True), (40, "i32", True), (40, "i16", True)]
    assert calls == [4, 4, 6, 6]  # B3: one chunk at q = 8, two at q = 40
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 4 and all(x.endswith("[OK]") and "col" in x for x in out)


def test_sweepdiag_body_on_cpu(capsys):
    make_queries = _load("benchmarks/make_queries.py")
    assert list(sweepdiag.QUERY_LENGTHS) == make_queries.QUERY_LENGTHS
    res = sweepdiag.run(48, 300, torch.device("cpu"), query_lengths=(5, 30, 60))
    assert [q["q"] for q in res["queries"]] == [5, 30, 60]
    assert all(q["gcups"] > 0 and q["seconds"] > 0 for q in res["queries"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 5 and out[-1].startswith("TOTAL: ")
    assert sweepdiag.parse_argv(["512", "1000", "--device", "cpu"])[:2] == (512, 1000)


def test_tremblbench_streams_and_equals_resident(tmp_path, monkeypatch, capsys):
    """The port's sprot-like database equals the JAX tools/dbbench.py's
    (drawn in several calls here); the rehearsal on 600 sequences streams
    under a budget of 64 KiB in 16 KiB chunks, and its last pass gives a
    resident engine's hits; the chunk is divided by the scale only where
    the working memory needs it."""
    monkeypatch.setattr(tremblbench, "GEN_CHUNK", 1000)
    monkeypatch.delenv("DBBENCH_CACHE", raising=False)
    jax_db = _load("tools/dbbench.py").make_sprotlike_db(300)
    db = tremblbench.make_sprotlike_db(300)
    for k in ("chars", "offsets", "lengths", "headers", "header_offsets"):
        assert np.array_equal(getattr(db, k), np.asarray(getattr(jax_db, k))), k
    assert int(db.lengths.sum()) > 300 * 1000 // tremblbench.GEN_CHUNK

    res = tremblbench.run(600, 1, 64 << 10, str(tmp_path / "store"), torch.device("cpu"),
                          chunk_bytes=16 << 10, query_lengths=(20, 45))
    assert res["copy"]["chunks"] > 1 and res["peak_device_bytes"] is None
    resident = SearchEngine(num_top=10, device="cpu")
    resident.set_database(res["db"])
    assert not resident.streaming
    want = [(r.scores, r.reference_ids) for r in resident.scan_many(res["queries"])]
    assert [(r.scores, r.reference_ids) for r in res["results"]] == want
    out = capsys.readouterr().out
    assert "BEST trembl rehearsal" in out and "copy stream:" in out

    lengths = res["db"].lengths
    assert tremblbench.chunk_for(lengths, 1 << 40, 20.0) == STREAM_CHUNK_BYTES
    assert tremblbench.chunk_for(lengths, 1 << 20, 20.0) == int(STREAM_CHUNK_BYTES / 20)
    assert tremblbench.parse_argv(["3", "--scale", "20", "--device", "cpu"]) == \
        (3, 20.0, torch.device("cpu"))


def test_colpass_takes_the_top_col_tile():
    """colpass's tile is the last tile of the largest col bucket, its
    lanes past the last subject empty: on swbench's ``sprot`` lengths,
    L = 7680 and subjects of 1,405 to 7,196 residues in every lane."""
    from pathlib import Path

    from cudasw4_tpu_torch.db.packing import plan_buckets

    lengths = colpass.sprot_lengths(Path(REPO))
    L, lens = colpass.top_col_tile(lengths)
    assert (L, int(lens.min()), int(lens.max()), int((lens > 0).sum())) == (7680, 1405, 7196, 4096)
    assert int(lens.sum()) == int(lengths[-4096:].sum())
    short = np.sort(np.concatenate([lengths[:-100], [2000] * 5]))
    start, stop, L2, ns, _ = [p for p in plan_buckets(short) if p[4] == "col"][-1]
    L2_, lens2 = colpass.top_col_tile(short)
    tail = (stop - start) % ns or ns
    assert L2_ == L2 and int((lens2 > 0).sum()) == tail and int(lens2.max()) == int(short[-1])
    assert not lens2[tail:].any()
