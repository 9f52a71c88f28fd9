"""The harness on the CPU: the generator, the window's arithmetic, the
roofline, the result line, the isolation rules, the plain reference
against a scalar scorer, and BENCHMARK.json against its files."""

from __future__ import annotations

import ast
import json
import os
import re
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch
from conftest import ROOT, tiny

from swbench import dbgen, drive, peaks, run, spec
from swbench.reference import scoring, sw

SPEC = dict(num_sequences=500, length_model="log-normal", median=60.0, sigma=0.6, min_length=11,
            max_length=400, length_seed=42)
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_same_seed_same_database():
    a = dbgen.make_database(SPEC, 2**33 + 5, "cpu", members=[77, 200])
    b = dbgen.make_database(SPEC, 2**33 + 5, "cpu", members=[77, 200])
    c = dbgen.make_database(SPEC, 2**33 + 6, "cpu", members=[77, 200])
    for x in ("chars", "offsets", "lengths"):
        assert np.array_equal(getattr(a, x), getattr(b, x))
    assert np.array_equal(a.lengths, c.lengths)  # every seed: the same sizes
    assert not np.array_equal(a.chars, c.chars)  # other residues
    assert a.num_sequences == 500 and np.all(np.diff(a.lengths) >= 0)
    real = np.concatenate([a.sequence(i) for i in range(a.num_sequences)])
    assert real.min() >= 0 and real.max() < 20 and len(real) == a.residues
    pads = a.chars[np.asarray(a.offsets[1:], np.int64) - 1][(a.lengths % 4) != 0]
    assert np.all(pads == dbgen.PAD)


def test_query_ids_follow_the_mix():
    lengths = dbgen.model_lengths(SPEC, [77, 77, 200])
    ids = dbgen.query_ids(lengths, {"member_lengths": [77, 77, 200], "longest_member": True})
    assert [lengths[i] for i in ids[:3]] == [77, 77, 200] and len(set(ids)) == 4
    assert ids[-1] == len(lengths) - 1
    q = dbgen.query_ids(lengths, {"quantiles": 4})
    assert q == [62, 187, 312, 437]


def test_fresh_rounds_keep_the_lengths():
    lengths = dbgen.model_lengths(SPEC)
    mix = {"quantiles": 6, "longest_member": True, "fresh": True}
    a, b = dbgen.Queries(lengths, mix, 2**31 + 9), dbgen.Queries(lengths, mix, 2**31 + 10)
    base = dbgen.query_ids(lengths, mix)
    rounds = [a.round(r) for r in range(4)] + [b.round(0)]
    for ids in rounds:  # every round and seed: the same lengths
        assert [lengths[i] for i in ids] == [lengths[i] for i in base]
    assert len({tuple(ids[:-1]) for ids in rounds}) == 5  # other entries
    assert a.round(2) == dbgen.Queries(lengths, mix, 2**31 + 9).round(2)  # from the seed
    same = dbgen.Queries(lengths, {"quantiles": 6}, 5)
    assert same.round(0) == same.round(3) == dbgen.query_ids(lengths, {"quantiles": 6})


def test_fixed_length_model():
    lengths = dbgen.model_lengths({"num_sequences": 50, "length_model": "fixed", "length": 256},
                                  members=[100])
    assert len(lengths) == 50 and lengths[0] == 100 and set(lengths[1:].tolist()) == {256}


@pytest.mark.parametrize("change", [
    {"state": "int8"}, {"length_model": "gamma"}, {"matrix": "pam250"}, {"gap_extend": 12},
    {"placement": "remote"}, {"residues": "swissprot"}, {"prefetch": True}, {"median": None},
])
def test_config_keys_are_all_run(change):
    """A value the harness does not run, or a key it does not know, stops
    the run: none is ignored."""
    config = json.loads((ROOT / "swbench" / "configs" / "sprot.json").read_text())
    spec.check_config(config)
    config.update(change)
    if change == {"median": None}:
        del config["median"]
    with pytest.raises(ValueError):
        spec.check_config(config)


@pytest.mark.parametrize("change", [
    {"entry": "align"}, {"arrivals": {"kind": "burst"}}, {"arrivals": {"kind": "poisson"}},
    {"queries": {"quantiles": 4, "lengths_from": "pdb"}}, {"think_time_s": 1},
])
def test_traffic_keys_are_all_run(change):
    traffic = json.loads((ROOT / "swbench" / "traffic" / "interactive.json").read_text())
    spec.check_traffic(traffic)
    traffic.update(change)
    with pytest.raises(ValueError):
        spec.check_traffic(traffic)


class _Result:
    def __init__(self, n):
        self.scores, self.reference_ids = [n], [0]


class _Engine:
    """Answers at once, each call taking ``dt`` seconds."""

    def __init__(self, dt):
        self.dt = dt
        self.calls = []

    def scan(self, q):
        self.calls.append(1)
        time.sleep(self.dt)
        return _Result(len(q))

    def scan_many(self, qs):
        self.calls.append(len(qs))
        time.sleep(self.dt * len(qs))
        return [_Result(len(q)) for q in qs]


def _three_queries():
    """A database of lengths 3, 5, 7 and its three entries as the queries."""
    db = dbgen.make_database(dict(SPEC, num_sequences=3), 1, "cpu", members=[3, 5, 7])
    return db, dbgen.Queries(db.lengths, {"member_lengths": [3, 5, 7]}, 1)


@pytest.mark.parametrize("entry", ["scan", "scan_many"])
def test_window_holds_whole_rounds(entry):
    db, queries = _three_queries()
    w = drive.run_window(_Engine(0.004), {"entry": entry}, db, queries, 0.03, seed=9)
    rounds = w.sent // 3
    assert w.seconds >= 0.03 and rounds >= 2 and w.sent == len(w.answers) == 3 * rounds
    assert w.units == (w.sent if entry == "scan" else rounds)  # calls of the entry
    assert w.residues == 15 * rounds
    assert sorted(k for k, _, _ in w.answers) == sorted([0, 1, 2] * rounds)
    assert len(w.latencies) == (w.sent if entry == "scan" else 0)


@pytest.mark.parametrize("entry", ["scan", "scan_many"])
def test_open_arrivals(entry):
    """Poisson arrivals: round(rate x seconds) queries at the seed's order of
    fixed gaps; a query's time runs from its due time, so queries that wait
    for a busy engine count the wait; scan_many takes all that are due."""
    db, queries = _three_queries()
    traffic = {"entry": entry, "arrivals": {"kind": "poisson", "rate_per_s": 400.0}}
    eng = _Engine(0.01)  # slower than the arrivals: a queue builds
    w = drive.run_window(eng, traffic, db, queries, 0.1, seed=3)
    assert w.sent == len(w.answers) == len(w.latencies) == 40
    assert sorted(drive._gaps(400.0, 40, 3)) == sorted(drive._gaps(400.0, 40, 4))
    assert min(w.latencies) >= 0.01 and max(w.latencies) > 0.1
    if entry == "scan":
        assert eng.calls == [1] * 40
    else:
        assert len(eng.calls) < 40 and sum(eng.calls) == 40


def test_rate_and_tail_over_the_whole_window():
    """The rate is all the work over all the window's time, and the tail is
    the 95th percentile of every query: not a median of rounds."""
    lat = [0.01] * 60 + [0.02] * 30 + [0.5] * 10  # the slow queries all in one round
    w = drive.Window(seconds=4.0, sent=100, units=2, residues=1000, latencies=lat)
    r = types.SimpleNamespace(window=w, db=types.SimpleNamespace(residues=2_000_000))
    assert run.read_metric("gcups", r) == pytest.approx(1000 * 2e6 / 4.0 / 1e9)
    p95 = run.read_metric("query_p95_ms", r)
    assert p95 == pytest.approx(statistics.quantiles(lat, n=20)[18] * 1e3)
    per_round = [statistics.quantiles(lat[:50], n=20)[18], statistics.quantiles(lat[50:], n=20)[18]]
    assert p95 != pytest.approx(statistics.median(per_round) * 1e3)


def test_roofline_by_hand():
    """132 SMs x 64 lanes x 1980 MHz = 16.727e12 lane operations a second; a
    cell costs 4 operations at two cells an operation, so 1e12 cells take
    2e12 / 16.727e12 = 0.11957 s; 3.35e11 bytes take 0.1 s."""
    name = "NVIDIA H100 80GB HBM3"
    assert peaks.least_seconds(name, 1e12, 0) == pytest.approx(2e12 / 16.72704e12)
    assert peaks.least_seconds(name, 0, 3.35e11) == pytest.approx(0.1)
    assert peaks.least_seconds(name, 1e12, 0, ndev=4) == pytest.approx(2e12 / 16.72704e12 / 4)
    assert peaks.least_seconds("some other card", 1e12, 0) is None


def test_result_line_schema():
    bench, cell, config, traffic = tiny("sprot.file21")
    out = run.run_cell(bench, cell, config, traffic, 2**31 + 7, 0.01, False,
                       [torch.device("cpu")], t0=time.perf_counter())
    res = out["result"]
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] == 4
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
    assert set(res["metrics"]) == {"gcups", "setup_s"}  # no card: no peak memory
    for name, m in res["metrics"].items():
        assert m["unit"] == units[name] and m["value"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(c["value"] == 0 == c["limit"] for c in res["checks"].values())
    json.dumps(res)


def test_traced_run_reads_per_layer_metrics():
    bench, cell, config, traffic = tiny("sprot.interactive")
    out = run.run_cell(bench, cell, config, traffic, 5, 0.01, True, [torch.device("cpu")])
    res = out["result"]
    assert res["correct"] is True
    assert set(res["metrics"]) == {"packing.real_share"}  # the rest reads a card's trace
    assert 0 < res["metrics"]["packing.real_share"]["value"] <= 100
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0


def test_forbidden_modules_compare_whole_names():
    assert run.forbidden_modules(["cudasw4_tpu_torch", "cudasw4_tpu_torch.engine", "jaxtyping",
                                  "numpy"]) == []
    assert run.forbidden_modules(["cudasw4_tpu.engine", "jax.numpy", "flax", "jaxlib"]) == [
        "cudasw4_tpu", "flax", "jax", "jaxlib"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_no_jax_and_reference_none_of_the_engine():
    for path in (ROOT / "swbench").rglob("*.py"):
        names = list(_imports(path))
        assert run.forbidden_modules(names) == [], path
        assert not {"benchmarks", "tools", "bench", "chip_smoke"} & {n.split(".")[0] for n in names}
        if "reference" in path.parts:
            assert not any(n.split(".")[0] == "cudasw4_tpu_torch" for n in names), path


def _scalar(q, s, m, gop, gex):
    """The textbook recurrence, cell by cell."""
    best, H = 0, [[0] * (len(s) + 1) for _ in range(len(q) + 1)]
    E = [[-10**9] * (len(s) + 1) for _ in range(len(q) + 1)]
    F = [[-10**9] * (len(s) + 1) for _ in range(len(q) + 1)]
    for i in range(1, len(q) + 1):
        for j in range(1, len(s) + 1):
            E[i][j] = max(E[i][j - 1] + gex, H[i][j - 1] + gop)
            F[i][j] = max(F[i - 1][j] + gex, H[i - 1][j] + gop)
            H[i][j] = max(0, H[i - 1][j - 1] + m[q[i - 1]][s[j - 1]], E[i][j], F[i][j])
            best = max(best, H[i][j])
    return best


def test_reference_against_scalar_scorer(monkeypatch):
    spec = dict(SPEC, num_sequences=40, median=25, max_length=60)
    db = dbgen.make_database(spec, 77, "cpu")
    rng = np.random.default_rng(1)
    queries = [rng.integers(0, 20, n).astype(np.int8) for n in (1, 9, 31)]
    queries.append(np.concatenate([db.sequence(39), db.sequence(39)[:5]]))  # a strong hit
    m = scoring.matrix("blosum62")
    assert m[0, 0] == 4 and m[17, 17] == 11 and m[20].tolist() == [-4] * 21
    want = np.array([[_scalar(q, db.sequence(i), m, -11, -1)
                      for i in range(db.num_sequences)] for q in queries])
    monkeypatch.setattr(sw, "BLOCK_CELLS", 300)  # many blocks
    ref = sw.Scorer(db.chars, db.offsets, db.lengths, "cpu", "blosum62", -11, -1)
    assert np.array_equal(ref.database(queries), want)
    assert np.array_equal(ref.database(queries, [3, 17, 39]), want[:, [3, 17, 39]])
    other = sw.Scorer(db.chars, db.offsets, db.lengths, "cpu", "blosum62", -8, -3)
    assert other.database(queries[-1:])[0].tolist() == [
        _scalar(queries[-1], db.sequence(i), m, -8, -3) for i in range(db.num_sequences)]
    pairs = [(k, i) for k in range(len(queries)) for i in (0, 17, 39)]
    got = ref.pairs([queries[k] for k, _ in pairs], [i for _, i in pairs])
    assert got.tolist() == [want[k, i] for k, i in pairs]
    scores, ids = sw.top_n(np.array([5, 9, 9, 1, 9]), 3)
    assert scores.tolist() == [9, 9, 9] and ids.tolist() == [1, 2, 4]


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_against_its_files():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["swbench"]
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and sorted(data["reduced"]) == sorted(c["reduced"])
    cells = BENCH["workloads"]
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["config"] in configs
        assert (ROOT / "swbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert json.loads((ROOT / configs[w["config"]]["file"]).read_text())["chips"] == w["chips"]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "swbench" / "metrics" / f"{m['name']}.py").is_file()
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", []):
            assert cell in moved.get("workloads", [cell])  # the cell reports what it moves
    for w in cells:
        layer = run.metrics_of(BENCH, w["name"], True)
        reported = {m["name"] for m in run.metrics_of(BENCH, w["name"], False)}
        assert layer and all(m["moves"] in reported for m in layer)
        assert reported > {"setup_s"}
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "swbench.run", "--workload", "sprot.file21",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
