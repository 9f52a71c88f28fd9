"""The port's host modules against the JAX package's on the same inputs:
``modifydb`` (files byte for byte, output and exit codes), the profiling
utilities (``ScopedTimer``'s line, ``device_trace`` on the CPU), and the
engine's ``qcap``, ``bucket_edges`` and ``warmup`` (results equal to the
JAX engine's, a query past ``qcap`` and one under ``state16`` included).

Tolerance: exact — bytes, text, scores, ids and order.
"""

import itertools
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from cudasw4_tpu.cli import align as jalign
from cudasw4_tpu.cli import makedb as jmakedb
from cudasw4_tpu.cli import modifydb as jmodifydb
from cudasw4_tpu.db.format import DBData as JaxDBData
from cudasw4_tpu.engine import SearchEngine as JaxEngine
from cudasw4_tpu.utils import profiling as jprof
from cudasw4_tpu_torch.cli import align, modifydb
from cudasw4_tpu_torch.db.format import DBData
from cudasw4_tpu_torch.engine import SearchEngine
from cudasw4_tpu_torch.ops import sw_cell
from cudasw4_tpu_torch.utils import profiling as tprof

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
DB_FA = os.path.join(FIXDIR, "golden_db.fa")
QUERIES = os.path.join(FIXDIR, "golden_queries.fa")
DB_FILES = ("metadata", "0chars", "0offsets", "0lengths", "0headers", "0headeroffsets",
            "0metadata")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- modifydb

def _two_dbs(tmp_path):
    """The golden database made by the JAX makedb, copied for each tool."""
    src = str(tmp_path / "src")
    assert jmakedb.run([DB_FA, src]) == 0
    out = {}
    for name in ("jax", "port"):
        for f in DB_FILES:
            shutil.copy(src + f, str(tmp_path / name) + f)
        out[name] = str(tmp_path / name)
    return out


def _run_both(capsys, argvs):
    """(rc, stdout) of the JAX tool and the port's on their own argv."""
    capsys.readouterr()
    got = {}
    for name, mod in (("jax", jmodifydb), ("port", modifydb)):
        rc = mod.run(argvs[name])
        got[name] = (rc, capsys.readouterr().out)
    return got


def _break(prefix, how):
    if how == "unsorted":
        lengths = np.fromfile(prefix + "0lengths", np.int32)
        lengths[[0, -1]] = lengths[[-1, 0]]
        lengths.tofile(prefix + "0lengths")
    elif how == "ascii":
        chars = np.fromfile(prefix + "0chars", np.uint8)
        np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)[chars % 20].tofile(prefix + "0chars")
    elif how == "histogram":
        raw = bytearray(open(prefix + "0metadata", "rb").read())
        raw[-8] ^= 1
        open(prefix + "0metadata", "wb").write(bytes(raw))
    elif how == "no_metadata":
        os.remove(prefix + "0metadata")


@pytest.mark.parametrize("how", ["ok", "unsorted", "ascii", "histogram", "no_metadata"])
def test_modifydb_verify_equals_jax(tmp_path, capsys, how):
    dbs = _two_dbs(tmp_path)
    for prefix in dbs.values():
        if how != "ok":
            _break(prefix, how)
    got = _run_both(capsys, {n: ["verify", p] for n, p in dbs.items()})
    assert got["port"] == got["jax"]
    assert got["port"][0] == (0 if how == "ok" else 1)


@pytest.mark.parametrize("op", ["lengthsToI32", "lengthsToI64", "convertcharstonumber1"])
def test_modifydb_operations_equal_jax(tmp_path, capsys, op):
    dbs = _two_dbs(tmp_path)
    if op == "convertcharstonumber1":
        for prefix in dbs.values():
            _break(prefix, "ascii")
    got = _run_both(capsys, {n: [op, p] for n, p in dbs.items()})
    assert got["port"][0] == got["jax"][0] == 0
    files = {"lengthsToI32": ["0lengths_i32"], "lengthsToI64": ["0lengths_i64"],
             "convertcharstonumber1": ["0chars"]}[op]
    for f in files:
        with open(dbs["port"] + f, "rb") as a, open(dbs["jax"] + f, "rb") as b:
            assert a.read() == b.read()
    if op != "convertcharstonumber1":  # the other prints its elapsed time
        assert got["port"][1].replace("port", "") == got["jax"][1].replace("jax", "")


@pytest.mark.parametrize("argv", [[], ["nosuchop", "x"]])
def test_modifydb_usage_and_unknown_operation(capsys, argv):
    got = _run_both(capsys, {"jax": argv, "port": argv})
    assert got["port"] == got["jax"]


# ------------------------------------------------------------ profiling

@pytest.mark.parametrize("cells", [None, 3.5e9])
def test_scoped_timer_line_equals_jax(monkeypatch, capsys, cells):
    clock = itertools.count(10.0, 0.25)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    with jprof.ScopedTimer("scan", cells=cells) as a:
        pass
    with tprof.ScopedTimer("scan", cells=cells) as b:
        pass
    jline, tline = capsys.readouterr().out.splitlines()
    assert tline == jline and a.seconds == b.seconds == 0.25
    with tprof.ScopedTimer("quiet", verbose=False):
        pass
    assert capsys.readouterr().out == ""


def test_device_trace_on_the_cpu(tmp_path):
    with tprof.device_trace(None) as path:
        assert path is None
    with tprof.device_trace(str(tmp_path / "t"), "x.json") as path:
        with tprof.span("sw:scan", torch.device("cpu")):
            torch.ones(4).sum()
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert path == str(tmp_path / "t" / "x.json") and "sw:scan" in names


def test_align_profile_tuning_and_warmup_keep_the_tsv(tmp_path, monkeypatch):
    """align --profile, --tuning (the layout's ratios unchanged, so the
    plan is too) and --warmup on the CPU write the JAX align's TSV."""
    from cudasw4_tpu_torch.db import packing

    monkeypatch.setattr(packing, "_tuning_applied", packing._tuning_applied)
    prefix = str(tmp_path / "gdb")
    assert jmakedb.run([DB_FA, prefix]) == 0
    jtsv, ttsv = tmp_path / "j.tsv", tmp_path / "t.tsv"
    assert jalign.run(["--query", QUERIES, "--db", prefix, "--tsv", "--of", str(jtsv)]) == 0
    cfg = tmp_path / "same.json"
    cfg.write_text(json.dumps({"cell_speedup": packing.CELL_SPEEDUP}))
    assert align.run(["--query", QUERIES, "--db", prefix, "--tsv", "--of", str(ttsv),
                      "--device", "cpu", "--profile", str(tmp_path / "prof"),
                      "--tuning", str(cfg), "--warmup"]) == 0
    assert ttsv.read_text() == jtsv.read_text()
    names = {e.get("name") for e in
             json.load(open(tmp_path / "prof" / "trace.json"))["traceEvents"]}
    assert "sw:scan_batch" in names


# ------------------------------------------------- qcap, edges, warmup

def _fields(seed=61):
    """3,000 sequences of 5-60 aa, most of 33-48 (a row, a cell and a
    long row bucket by default), with duplicated sequences for ties."""
    rng = np.random.default_rng(seed)
    lengths = np.concatenate([rng.integers(5, 33, 300), rng.integers(33, 49, 2600),
                              rng.integers(49, 61, 100)])
    seqs = [rng.integers(0, 20, size=int(n)).astype(np.int8) for n in lengths]
    seqs[10] = seqs[400] = seqs[600]
    seqs.sort(key=len)
    lens = np.array([len(s) for s in seqs], np.int32)
    offsets = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum((lens + 3) // 4 * 4, out=offsets[1:])
    chars = np.full(int(offsets[-1]), 20, np.int8)
    for s, a in zip(seqs, offsets[:-1]):
        chars[a:a + len(s)] = s
    names = [b"s%d" % i for i in range(len(seqs))]
    hoff = np.zeros(len(seqs) + 1, np.uint64)
    np.cumsum([len(h) for h in names], out=hoff[1:])
    return dict(chars=chars, offsets=offsets.astype(np.uint64), lengths=lens,
                headers=np.frombuffer(b"".join(names), np.uint8), header_offsets=hoff)


def _results(rs):
    return [(r.scores, r.reference_ids) for r in rs]


@pytest.fixture(scope="module")
def qcap_setup():
    fields = _fields()
    rng = np.random.default_rng(62)
    queries = [rng.integers(0, 20, size=n).astype(np.int8) for n in (20, 40, 70)]
    return fields, queries


@pytest.mark.parametrize("qcap,edges,state16", [
    (64, None, False), (32, None, False), (32, None, True), (64, [16, 32, 48, 64], False),
])
def test_qcap_and_bucket_edges_equal_jax(qcap_setup, qcap, edges, state16):
    fields, queries = qcap_setup
    jeng = JaxEngine(num_top=8, qcap=qcap, bucket_edges=edges)
    jeng.state16 = state16
    jeng.set_database(JaxDBData(**fields))
    eng = SearchEngine(num_top=8, device="cpu", qcap=qcap, bucket_edges=edges)
    eng.state16 = state16
    eng.set_database(DBData(**fields))
    assert [(b.L, b.NS, b.kernel) for b in eng.packed.buckets] == \
        [(b.L, b.NS, b.kernel) for b in jeng.packed.buckets]
    assert eng.qcap == qcap and eng._single_qpad(queries[2])[0].shape[0] % qcap == 0
    assert eng._exact_for(queries[2]) and eng._exact_for(queries[0]) == (not state16)
    before = sw_cell.score_bucket_cell.plain_calls16
    assert _results([eng.scan(q) for q in queries]) == _results([jeng.scan(q) for q in queries])
    assert (sw_cell.score_bucket_cell.plain_calls16 > before) == state16


def test_bucket_edges_reach_the_tile_store(qcap_setup, tmp_path):
    fields, queries = qcap_setup
    edges = [24, 48, 64]
    eng = SearchEngine(num_top=8, device="cpu", bucket_edges=edges)
    eng.set_database(DBData(**fields), pack_cache=str(tmp_path / "s.npz"))
    assert [b.L for b in eng.packed.buckets] == edges
    assert isinstance(eng.packed.buckets[0].tiles, np.memmap)
    streamed = SearchEngine(num_top=8, device="cpu", bucket_edges=edges, max_device_bytes=1000)
    streamed.set_database(DBData(**fields))
    assert streamed.streaming and [b.L for b in streamed.packed.buckets] == edges
    assert _results(streamed.scan_many(queries)) == _results(eng.scan_many(queries))


def test_warmup_contract_on_the_cpu(qcap_setup):
    fields, queries = qcap_setup
    eng = SearchEngine(num_top=8, device="cpu")
    with pytest.raises(RuntimeError):
        eng.warmup()
    eng.set_database(DBData(**fields))
    assert eng.warmup() == 0
    warm = SearchEngine(num_top=8, device="cpu", warmup=True)
    warm.set_database(DBData(**fields))
    assert _results(warm.scan_many(queries)) == _results(eng.scan_many(queries))
    streamed = SearchEngine(num_top=8, device="cpu", max_device_bytes=1000)
    streamed.set_database(DBData(**fields))
    assert streamed.streaming and streamed.warmup() == 1


def test_kernel_ab_sass_ignores_cubin_layout(monkeypatch):
    """kernel_ab compares each kernel's instructions and encodings, not the
    listing's layout: cuobjdump pads its columns to each cubin's widest
    line and prints the next cubin's header after a cubin's last kernel,
    so the same kernel in a library of several units lists differently."""
    import types

    from cudasw4_tpu_torch.tools import kernel_ab

    head = "\nFatbin elf code:\n================\narch = sm_90a\n\n\tcode for sm_90a\n"

    def listing(width, extra_cubin):
        pad = " " * width
        k = ("\t\tFunction : _ZN12_GLOBAL__N_{0}13sw_col_kernelEPKa\n"
             "        /*0000*/   LDC R1, c[0x0][0x28] ;" + pad + "/* 0x00000a00ff017b82 */\n"
             "        /*0010*/   EXIT ;" + pad + "/* 0x000000000000794d */\n\t\t.......\n")
        text = head + k.format(7)
        if extra_cubin:
            text += head + k.format(9).replace("sw_col_kernel", "sw_row_col_kernel").replace(
                "13sw_row", "17sw_row")
        return text

    out = {}
    monkeypatch.setattr(kernel_ab.shutil, "which", lambda name: "cuobjdump")
    for name, (width, extra) in {"a": (3, False), "b": (9, True)}.items():
        monkeypatch.setattr(kernel_ab.subprocess, "run", lambda *a, **k: types.SimpleNamespace(
            stdout=listing(width, extra)))
        out[name] = kernel_ab._sass("lib.so")
    assert out["a"]["sw_col_kernelEPKa"] == out["b"]["sw_col_kernelEPKa"]
    assert "LDC R1, c[0x0][0x28] ; /* 0x00000a00ff017b82 */" in out["a"]["sw_col_kernelEPKa"]
    assert "sw_row_col_kernelEPKa" in out["b"]
