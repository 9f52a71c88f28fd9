"""The port's benchmark entry points on the CPU against the JAX package's:
``cudasw4_tpu_torch.bench`` against the root bench.py (the cells of one
configuration, the one JSON line and the ``# L=`` lines), its refusal to
run without a card and its device-init watchdog, and
``cudasw4_tpu_torch.tools.dbbench`` against the JAX engine's hits on the
same sprot-like database.  The root bench.py and tools/dbbench.py are not
packages: they are loaded by path.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cudasw4_tpu.engine import SearchEngine as JaxSearchEngine
from cudasw4_tpu_torch import bench
from cudasw4_tpu_torch.tools import dbbench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SHORT = (5, 30, 60)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(relpath, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_bench(monkeypatch):
    monkeypatch.syspath_prepend(REPO)  # bench.main imports benchmarks.make_queries
    return _load("bench.py", "jax_root_bench")


@pytest.mark.parametrize("length", [48, 64])
def test_run_config_counts_the_jax_cells(jax_bench, length):
    """One pass's cells as the JAX bench counts them, on the same pseudo
    database and queries; both report a positive rate."""
    queries = bench.make_queries(SHORT)
    gcups, secs, cells = bench.run_config(300, length, queries, 1, CPU)
    j_gcups, j_secs, j_cells = jax_bench._run_config(300, length, queries, 1)
    assert cells == j_cells == float(sum(SHORT)) * 300 * length
    assert gcups > 0 and j_gcups > 0 and secs > 0 and j_secs > 0


def _fixed(num, length, queries, reps, device=None):
    """A configuration's result that depends only on its arguments."""
    return 1000.0 + length / 3 + reps, 0.5 + length / 77, float(sum(map(len, queries))) * length * 7


@pytest.mark.parametrize("mode", ["sweep", "peak"])
def test_main_prints_the_jax_lines(jax_bench, monkeypatch, mode):
    """Given the same configuration results, both mains print the same JSON
    line and the same ``# L=`` lines, and ask for the same configurations
    with the same queries."""
    monkeypatch.setenv("BENCH_MODE", mode)
    for k in ("BENCH_NUM_SEQS", "BENCH_SEQ_LEN", "BENCH_REPS"):
        monkeypatch.delenv(k, raising=False)
    calls = {"jax": [], "port": []}

    def recorder(key):
        def run(*args):
            calls[key].append(args[:4])
            return _fixed(*args)
        return run

    monkeypatch.setattr(jax_bench, "_run_config", recorder("jax"))
    monkeypatch.setattr(jax_bench, "_init_devices_watchdog", lambda timeout_s: None)
    monkeypatch.setattr(bench, "run_config", recorder("port"))
    outs = {}
    for key, fn in (("jax", jax_bench.main), ("port", lambda: bench.main(["--device", "cpu"]))):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            fn()
        outs[key] = out.getvalue(), [x for x in err.getvalue().splitlines() if x.startswith("# L=")]
    assert outs["port"] == outs["jax"]
    assert calls["port"] == calls["jax"]
    stdout, lines = outs["port"]
    line = json.loads(stdout)
    assert stdout.count("\n") == 1 and line["metric"] == bench.metric_name(mode)
    assert len(lines) == (6 if mode == "sweep" else 0)
    assert [c[:2] for c in calls["port"]] == (
        [(1_000_000, n) for n in bench.SWEEP_LENGTHS] if mode == "sweep" else [(500_000, 256)])


def _run_bench(code_or_module, env_extra):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="", **env_extra)
    args = ["-m", code_or_module] if code_or_module.startswith("cudasw4") else ["-c", code_or_module]
    return subprocess.run([sys.executable, *args], capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=300)


@pytest.mark.parametrize("mode", ["sweep", "peak"])
def test_no_card_prints_an_error_line(mode):
    r = _run_bench("cudasw4_tpu_torch.bench", {"BENCH_MODE": mode})
    assert r.returncode == 2, r.stderr
    lines = r.stdout.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == bench.metric_name(mode)
    assert line["value"] == 0.0 and line["vs_baseline"] == 0.0 and "CUDA" in line["error"]


WATCHDOG = """
import sys, time, torch
from cudasw4_tpu_torch import bench
torch.cuda.is_available = lambda: True
bench.touch_device = lambda device: time.sleep(60)
bench.run_config = None  # never reached
sys.exit(bench.main([]))
"""


def test_device_init_watchdog_exits_3():
    r = _run_bench(WATCHDOG, {"BENCH_INIT_TIMEOUT": "0.5"})
    assert r.returncode == 3, r.stderr
    lines = r.stdout.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["value"] == 0.0 and line["error"] == "device init exceeded 0.5s"


def test_dbbench_gives_the_jax_engine_hits(monkeypatch, capsys):
    """tools.dbbench on the CPU: its last pass's top 10 equal the JAX
    engine's ``scan_many`` hits on the JAX tools/dbbench.py's database, and
    it prints that tool's lines."""
    monkeypatch.delenv("DBBENCH_CACHE", raising=False)
    res = dbbench.run(300, 1, CPU, query_lengths=SHORT)
    jax_db = _load("tools/dbbench.py", "jax_tools_dbbench").make_sprotlike_db(300)
    assert np.array_equal(res["db"].lengths, np.asarray(jax_db.lengths))
    engine = JaxSearchEngine(num_top=10)
    engine.set_database(jax_db)
    want = [(r.scores, r.reference_ids) for r in engine.scan_many(bench.make_queries(SHORT))]
    assert [(r.scores, r.reference_ids) for r in res["results"]] == want
    assert all(len(s) == 10 for s, _ in want)
    assert res["cells"] == sum(SHORT) * res["residues"] and res["peak_device_bytes"] is None
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("DB: 300 seqs, ")
    for head in ("first pass (incl. compile): ", "pass: ", "BEST sprot-like total: "):
        assert sum(x.startswith(head) for x in out) == 1, head
    assert dbbench.parse_argv(["1000", "3", "--device", "cpu"]) == (1000, 3, CPU)
    assert dbbench.parse_argv(["--device", "cpu"])[:2] == (200_000, 2)
