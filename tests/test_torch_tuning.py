"""The port's tuning (db/packing.py ``apply_tuning``, ``auto_apply_tuning``,
the engine's hook) and its gridsearch reduction against the JAX package's,
on the same inputs; gridsearch run on the CPU with a tiny grid.

Every module global that a test changes, in both packages, is restored by
``monkeypatch`` (the suite's workers share modules between files).
Tolerance: exact — configs, plans and geometry are compared as values.
"""

import json

import numpy as np
import pytest
import torch

import cudasw4_tpu.db.packing as jp
import cudasw4_tpu_torch.db.packing as tp
from cudasw4_tpu.cli import gridsearch as jgs
from cudasw4_tpu.ops import sw_pallas_cell, sw_pallas_col
from cudasw4_tpu_torch import engine as teng
from cudasw4_tpu_torch.cli import gridsearch as tgs
from cudasw4_tpu_torch.ops import sw_cell, sw_col


@pytest.fixture
def geometry(monkeypatch):
    """Both packages' tunable globals at the library defaults, restored
    after the test."""
    for mod, name, value in (
        (jp, "CELL_SPEEDUP", 1.75), (jp, "COL_SPEEDUP", 2.8), (jp, "CELL_MAX_L", 768),
        (jp, "_tuning_applied", False),
        (sw_pallas_cell, "DEFAULT_UNROLL", 8), (sw_pallas_col, "DEFAULT_UNROLL", 8),
        (sw_pallas_col, "NQC", 3072), (sw_pallas_col, "LC", 128),
        (tp, "CELL_SPEEDUP", 1.75), (tp, "COL_SPEEDUP", 2.8), (tp, "CELL_MAX_L", 768),
        (tp, "_tuning_applied", False),
        (sw_cell, "DEFAULT_UNROLL", 8), (sw_col, "DEFAULT_UNROLL", 8),
        (sw_col, "NQC", 3072), (sw_col, "LC", 128),
    ):
        monkeypatch.setattr(mod, name, value)
    monkeypatch.delenv("CUDASW4_TPU_TORCH_AUTO_TUNING", raising=False)
    return monkeypatch


def _port_state():
    return (tp.CELL_SPEEDUP, tp.COL_SPEEDUP, tp.CELL_MAX_L, sw_col.NQC, sw_col.LC,
            sw_cell.DEFAULT_UNROLL, sw_col.DEFAULT_UNROLL)


# The row sets of tests/test_gridsearch.py, with the default unrolls each
# ran under: (cell/cellbatch, col).
ROW_SETS = {
    "ratios": ((8, 8), [
        ("row", 256, 4, 8, 128, 0.1, 100.0), ("cell", 256, 4, 8, 128, 0.1, 175.0),
        ("cell", 256, 8, 8, 128, 0.1, 160.0), ("row", 1024, 4, 8, 128, 0.1, 60.0),
        ("col", 1024, 4, 8, 128, 0.1, 168.0),
    ]),
    "roundtrip": ((8, 8), [
        ("row", 256, 4, 8, 128, 0.1, 100.0), ("cell", 256, 4, 8, 128, 0.1, 210.0),
    ]),
    "no_row_baseline": ((8, 8), [("cell", 256, 4, 8, 128, 0.1, 175.0)]),
    "geometry": ((8, 8), [
        ("cell", 256, 4, 8, 128, 0.1, 200.0), ("cell", 256, 8, 8, 128, 0.1, 180.0),
        ("col", 256, 4, 8, 128, 0.1, 150.0), ("cell", 512, 4, 8, 128, 0.1, 210.0),
        ("col", 512, 8, 8, 128, 0.1, 190.0), ("cell", 1024, 4, 8, 128, 0.1, 220.0),
        ("col", 1024, 8, 8, 128, 0.1, 280.0),
    ]),
    "unbracketed": ((8, 8), [
        ("cell", 256, 4, 8, 128, 0.1, 200.0), ("col", 256, 4, 8, 128, 0.1, 150.0),
    ]),
    "noise_tie": ((4, 8), [
        ("cell", 256, 4, 8, 128, 0.1, 200.0), ("cell", 256, 8, 8, 128, 0.1, 203.0),
    ]),
    "noise_flip": ((4, 8), [
        ("cell", 256, 4, 8, 128, 0.1, 200.0), ("cell", 256, 8, 8, 128, 0.1, 210.0),
    ]),
    "default_unmeasured": ((4, 8), [
        ("col", 1024, 4, 8, 128, 0.1, 150.0), ("col", 1024, 16, 8, 128, 0.1, 151.0),
    ]),
    "cellbatch_decides": ((8, 8), [
        ("cell", 256, 4, 8, 128, 0.1, 300.0), ("cell", 256, 8, 8, 128, 0.1, 200.0),
        ("cellbatch", 256, 8, 8, 128, 0.1, 900.0), ("cellbatch", 256, 4, 8, 128, 0.1, 880.0),
        ("row", 256, 8, 8, 128, 0.1, 100.0),
    ]),
}


@pytest.mark.parametrize("name", sorted(ROW_SETS))
def test_derive_tuning_equals_jax(geometry, name):
    (cu, colu), rows = ROW_SETS[name]
    geometry.setattr(sw_pallas_cell, "DEFAULT_UNROLL", cu)
    geometry.setattr(sw_cell, "DEFAULT_UNROLL", cu)
    geometry.setattr(sw_pallas_col, "DEFAULT_UNROLL", colu)
    geometry.setattr(sw_col, "DEFAULT_UNROLL", colu)
    assert tgs.derive_tuning(rows) == jgs.derive_tuning(rows)


@pytest.mark.parametrize("rows", [
    [(2048, 128, 2048, 301.0), (3072, 128, 2048, 300.0)],
    [(3072, 128, 2048, 300.0), (2048, 128, 2048, 301.0)],
    [(2048, 128, 2048, 310.0), (3072, 128, 2048, 300.0)],
    [(3072, 128, 2048, 300.0), (2048, 128, 2048, 310.0)],
    [(2048, 128, 2048, 200.0), (1024, 256, 2048, 201.0)],
    [],
])
def test_select_col_geometry_equals_jax(rows):
    inc = (3072, 128)
    assert tgs.select_col_geometry(rows, inc) == jgs.select_col_geometry(rows, inc)


@pytest.mark.parametrize("bad", [
    {"cell_max_l": 100}, {"col_nqc": 1000}, {"col_lc": 64}, {"col_unroll": 3},
    {"cell_unroll": 1}, {"cell_speedup": 2.0, "col_nqc": 2000},
])
def test_apply_tuning_raises_where_jax_raises_and_never_half_applies(geometry, bad):
    before = _port_state()
    with pytest.raises(ValueError):
        jp.apply_tuning(dict(bad))
    with pytest.raises(ValueError):
        tp.apply_tuning(dict(bad))
    assert _port_state() == before
    # The port's own limit: no cell group instance past 768 columns.
    with pytest.raises(ValueError):
        tp.apply_tuning({"cell_max_l": 784})
    assert _port_state() == before


def test_emit_apply_roundtrip_and_geometry(geometry, tmp_path):
    """An emitted config applies (unknown keys ignored); the geometry keys
    move the layout choice as in the JAX package; the unrolls are validated
    and not applied."""
    cfg = tgs.derive_tuning(ROW_SETS["roundtrip"][1])
    p = tmp_path / "tuning.json"
    p.write_text(json.dumps({**cfg, "mystery": 1}))
    tp.apply_tuning(str(p))
    assert tp.CELL_SPEEDUP == 2.1 and tp._tuning_applied
    geo = {"cell_max_l": 256, "cell_unroll": 4, "col_unroll": 4, "col_nqc": 2048,
           "col_lc": 256, "col_speedup": 99.0, "cell_speedup": 99.0}
    assert tp.choose_bucket_layout(512, 4096) == jp.choose_bucket_layout(512, 4096)
    tp.apply_tuning(geo)
    jp.apply_tuning(geo)
    assert tp.choose_bucket_layout(512, 4096) == jp.choose_bucket_layout(512, 4096)
    assert tp.choose_bucket_layout(512, 4096)[1] == "col"
    assert (tp.CELL_MAX_L, sw_col.NQC, sw_col.LC) == (256, 2048, 256)
    assert (sw_cell.DEFAULT_UNROLL, sw_col.DEFAULT_UNROLL) == (8, 8)


@pytest.mark.parametrize("cfg", [
    {},
    {"cell_speedup": 3.5, "col_speedup": 1.1},
    {"cell_max_l": 256, "col_lc": 256},
    {"cell_max_l": 512, "col_speedup": 6.0, "col_nqc": 2048},
])
def test_plan_under_config_equals_jax(geometry, cfg):
    rng = np.random.default_rng(7)
    lengths = np.sort(np.concatenate([
        rng.integers(5, 300, 9000), rng.integers(300, 800, 5000),
        rng.integers(800, 3000, 200), [9000],
    ])).astype(np.int64)
    if cfg:
        tp.apply_tuning(cfg)
        jp.apply_tuning(cfg)
    assert tp.plan_buckets(lengths) == jp.plan_buckets(lengths)
    edges = [48, 96, 256, 512]
    assert tp.plan_buckets(lengths, edges) == jp.plan_buckets(lengths, edges)


def _packaged(tmp_path, geometry, platform="FakeCard X", extra=None):
    d = tmp_path / "tuning"
    d.mkdir()
    (d / "a_bad.json").write_text("{ not json")
    (d / "b_other.json").write_text(json.dumps({"platform": "Other", "cell_speedup": 9.0}))
    (d / "c_card.json").write_text(json.dumps({"platform": platform, "cell_speedup": 4.25,
                                              **(extra or {})}))
    geometry.setattr(tp, "TUNING_DIR", str(d))
    return d


def test_auto_apply_tuning(geometry, tmp_path):
    d = _packaged(tmp_path, geometry)
    assert tp.auto_apply_tuning("No such card") is None and tp.CELL_SPEEDUP == 1.75
    assert tp.auto_apply_tuning("FakeCard X") == str(d / "c_card.json")
    assert tp.CELL_SPEEDUP == 4.25
    tp.CELL_SPEEDUP = 1.75
    assert tp.auto_apply_tuning("FakeCard X") is None  # once a process
    assert tp.CELL_SPEEDUP == 1.75


def test_auto_apply_tuning_loses_to_explicit_and_opts_out(geometry, tmp_path):
    _packaged(tmp_path, geometry)
    tp.apply_tuning({"cell_speedup": 2.0})
    assert tp.auto_apply_tuning("FakeCard X") is None and tp.CELL_SPEEDUP == 2.0
    geometry.setattr(tp, "_tuning_applied", False)
    geometry.setenv("CUDASW4_TPU_TORCH_AUTO_TUNING", "0")
    assert tp.auto_apply_tuning("FakeCard X") is None and tp.CELL_SPEEDUP == 2.0
    # A packaged config with an invalid value is skipped, never raised.
    geometry.delenv("CUDASW4_TPU_TORCH_AUTO_TUNING")
    tmp2 = tmp_path / "second"
    tmp2.mkdir()
    _packaged(tmp2, geometry, extra={"col_nqc": 1000})
    assert tp.auto_apply_tuning("FakeCard X") is None and tp.CELL_SPEEDUP == 2.0


def test_engine_applies_packaged_tuning_on_a_card_only(geometry, tmp_path):
    calls = []
    geometry.setattr(tp, "auto_apply_tuning", lambda name, verbose=False: calls.append(name))
    teng.SearchEngine(device="cpu")
    assert calls == []
    geometry.setattr(teng, "resolve_device", lambda device=None: torch.device("cuda"))
    geometry.setattr(torch.cuda, "get_device_name", lambda device=None: "FakeCard X")
    teng.SearchEngine()
    assert calls == ["FakeCard X"]


def test_gridsearch_run_on_cpu(geometry, tmp_path, capsys):
    geometry.setattr(sw_col, "LC", 16)
    tsv, cfg = tmp_path / "sweep.tsv", tmp_path / "tuning.json"
    assert tgs.run(["--device", "cpu", "--lengths", "32", "--querylengths", "16",
                    "--chars", "4096", "--reps", "1", "--unrolls", "4,8",
                    "--of", str(tsv), "--emit-config", str(cfg)]) == 0
    out = capsys.readouterr().out
    assert "sweeping 8" in out and "CPU sweep: speed ratios are not meaningful" in out
    lines = tsv.read_text().splitlines()
    assert lines[0] == "kernel\tlength\tunroll\ttiles\tqlen\tseconds\tgcups"
    assert [line.split("\t")[0] for line in lines[1:]] == ["row", "cell", "cellbatch", "col"]
    emitted = json.loads(cfg.read_text())
    assert emitted["platform"] == "cpu" and "cell_speedup" in emitted
    assert (sw_col.LC, sw_col.NQC) == (16, 3072)  # nothing was applied
