"""The port's makedb and align CLIs with ``--device cpu`` against the golden
fixtures and the JAX package's CLIs, run in-process through their ``run``
functions (tests/test_torch_isolation.py starts the ``python -m`` entry
points themselves).

Tolerance: exact — output files and text are compared byte for byte.
"""

import os

import pytest
import torch

from cudasw4_tpu.cli import align as jax_align
from cudasw4_tpu.cli import makedb as jax_makedb
from cudasw4_tpu_torch.cli import align, makedb

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
DB_FA = os.path.join(FIXDIR, "golden_db.fa")
QUERIES = os.path.join(FIXDIR, "golden_queries.fa")
DB_FILES = ("metadata", "0chars", "0offsets", "0lengths", "0headers",
            "0headeroffsets", "0metadata")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers,
    and torch's thread pool spinning against them slows these tests about
    tenfold (alone they take the same time either way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tsv_lines(stdout):
    return "".join(
        line + "\n" for line in stdout.splitlines()
        if line and (line[0].isdigit() or line.startswith("Query number"))
    )


@pytest.mark.parametrize("mat,golden", [
    ("blosum62", "golden_top10.tsv"),
    ("blosum62_full", "golden_top10_full.tsv"),
])
def test_align_cli_reproduces_golden_tsv(tmp_path, capsys, mat, golden):
    prefix = str(tmp_path / "gdb")
    assert makedb.run([DB_FA, prefix]) == 0
    capsys.readouterr()
    assert align.run([
        "--query", QUERIES, "--db", prefix, "--top", "10", "--tsv",
        "--mat", mat, "--device", "cpu",
    ]) == 0
    with open(os.path.join(FIXDIR, golden)) as f:
        assert _tsv_lines(capsys.readouterr().out) == f.read()


def test_makedb_and_plain_output_equal_jax_cli(tmp_path, capsys):
    """Both packages' makedb write the same 6 files and print the same
    summary, and both aligns write the same plain-text result file and
    the same console lines."""
    outs = {}
    for name, mk in (("jax", jax_makedb), ("port", makedb)):
        assert mk.run([DB_FA, str(tmp_path / name)]) == 0
        outs[name] = [line for line in capsys.readouterr().out.splitlines()
                      if not line.startswith("TIMING")]
    assert outs["port"] == outs["jax"]
    for name in DB_FILES:
        with open(str(tmp_path / "jax") + name, "rb") as a, \
             open(str(tmp_path / "port") + name, "rb") as b:
            assert a.read() == b.read(), name
    runs = {}
    for name, al, extra in (("jax", jax_align, []), ("port", align, ["--device", "cpu"])):
        of = str(tmp_path / f"{name}.txt")
        assert al.run(["--query", QUERIES, "--db", str(tmp_path / "port"),
                       "--top", "5", "--of", of, *extra]) == 0
        with open(of) as f:
            runs[name] = (f.read(), capsys.readouterr().out)
    assert runs["port"] == runs["jax"]
    assert runs["jax"][0].startswith("Query 0, header")


def test_cli_unported_options_raise(tmp_path, capsys):
    prefix = str(tmp_path / "gdb")
    assert makedb.run([DB_FA, prefix]) == 0
    for extra in (["--tuning", "t.json"], ["--profile", "trace"]):
        with pytest.raises(NotImplementedError):
            align.run(["--query", QUERIES, "--db", prefix, "--device", "cpu", *extra])
    assert align.run(["--query", QUERIES, "--db", prefix, "--manyPassType_small", "Float"]) == 1
    # Streaming and the tile store, which waited for a later slice, run.
    assert makedb.run([DB_FA, prefix, "--prepack"]) == 0
    assert align.run(["--query", QUERIES, "--db", prefix, "--device", "cpu",
                      "--maxGpuMem", "1K"]) == 0
    capsys.readouterr()
    assert align.run(["--db", prefix]) == 0
    assert "Query is missing" in capsys.readouterr().out
