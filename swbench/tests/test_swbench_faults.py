"""The comparison that decides ``correct`` catches what it must, on the CPU
at a small size, through the whole run but the look for a card: the
lower-precision control (int16 state without its re-score) and each fault
the cells can have, planted in the engine's timed path, come out not
correct; the sound run comes out correct."""

from __future__ import annotations

import pytest
import torch
from conftest import tiny

from cudasw4_tpu_torch import substitution
from cudasw4_tpu_torch.db import packing
from cudasw4_tpu_torch.ops import sw_cell
from cudasw4_tpu_torch.parallel import sharding
from swbench import control, run
from swbench.reference import check

CPU = [torch.device("cpu")]


@pytest.fixture
def cell_buckets(monkeypatch):
    """Cell tiles at this size too, where the int16 state lives."""
    monkeypatch.setattr(packing, "CELL_SPEEDUP", 1000.0)


def _run(cell_name, patch=None, devices=CPU, config_update=None, seed=2**32 + 3):
    bench, cell, config, traffic = tiny(cell_name)
    config.update(config_update or {})
    out = run.run_cell(bench, cell, config, traffic, seed, 0.01, False, devices, patch=patch)
    return out["result"]


def _checks(res):
    return {k: c["value"] for k, c in res["checks"].items()}


@pytest.mark.parametrize("cell", ["sprot.file21", "sprot.interactive", "trembl.interactive"])
def test_sound_run_is_correct(cell, cell_buckets):
    res = _run(cell)
    assert res["correct"] is True and res["failed"] == 0


@pytest.mark.parametrize("cell", ["sprot.file21", "sprot.interactive"])
def test_int16_state_runs_as_the_configuration_states(cell, cell_buckets, monkeypatch):
    """``state: int16`` runs the engine's int16 state with its overflow
    re-score, exact: a sound run, the longest entry's own hit past a
    lowered SAT re-scored."""
    monkeypatch.setattr(sw_cell, "SAT", 200)
    seen = []
    res = _run(cell, patch=lambda e: seen.append(e.state16), config_update={"state": "int16"})
    assert seen == [True] and res["correct"] is True
    seen.clear()
    _run(cell, patch=lambda e: seen.append(e.state16))
    assert seen == [False]
    with pytest.raises(ValueError):  # int16 state has no int16 control
        _run(cell, patch=control.int16_control, config_update={"state": "int16"})


def test_matrix_and_gaps_reach_engine_and_reference(cell_buckets, monkeypatch):
    """Gaps of 8 to open and 3 to extend: sound on both sides; an engine
    that keeps its default gaps is caught."""
    assert _run("sprot.interactive", config_update={"gap_open": 8, "gap_extend": 3})["correct"]
    make = substitution.make_scoring_config
    monkeypatch.setattr(substitution, "make_scoring_config", lambda name, gop, gex: make(name))
    res = _run("sprot.interactive", config_update={"gap_open": 8, "gap_extend": 3})
    assert res["correct"] is False and _checks(res)["wrong_score"] > 0


@pytest.mark.parametrize("cell", ["sprot.file21", "sprot.interactive", "trembl.interactive"])
def test_int16_control_is_not_correct(cell, cell_buckets, monkeypatch):
    """SAT lowered below the longest entry's own hit, as 32,000 lies below
    it at the cells' sizes; on the streamed database, which has no int16
    state, the reported scores saturate at a lowered int16 ceiling."""
    monkeypatch.setattr(sw_cell, "SAT", 200)
    monkeypatch.setattr(control, "INT16_MAX", 200)
    res = _run(cell, patch=control.int16_control)
    assert res["correct"] is False and _checks(res)["wrong_score"] > 0


def _alter_answer(engine):
    """An answer altered where it is produced: the first hit's score + 1."""
    finish = engine._result

    def result(vals, ids, nq, seconds, overflows=0):
        r = finish(vals, ids, nq, seconds, overflows)
        r.scores[0] += 1
        return r

    engine._result = result


def _stale_state(engine):
    """A scan that returns its state unchanged: the answer of the call
    before, from the second call on."""
    scan = engine.scan
    last = []

    def stale(seq):
        r = scan(seq)
        out = last[0] if last else r
        last[:] = [r]
        return out

    engine.scan = stale


def _half_left_out(engine):
    """Half of the database's slots left out of the top N."""
    top_n = engine._top_n

    def half(scores, ids=None):
        scores = scores.clone()
        scores[..., scores.shape[-1] // 2 :] = -1
        return top_n(scores, ids)

    engine._top_n = half


@pytest.mark.parametrize("fault,cell,number", [
    (_alter_answer, "sprot.file21", "wrong_score"),
    (_stale_state, "sprot.interactive", "wrong_score"),
    (_half_left_out, "sprot.file21", "wrong_top"),
    (_half_left_out, "sprot.file21", "missed_own"),
    (_half_left_out, "sprot.interactive", "wrong_top"),
    (_half_left_out, "sprot.file21", "outranked_long"),
    (_half_left_out, "sprot.interactive", "outranked_long"),
])
def test_fault_is_not_correct(fault, cell, number, cell_buckets, monkeypatch):
    """Each fault fails its number; the long query's slice is the whole
    database here (SLICES 1), so that its scan sees what was left out."""
    monkeypatch.setattr(check, "SLICES", 1)
    res = _run(cell, patch=fault)
    assert res["correct"] is False and _checks(res)[number] > 0


def test_mesh_without_the_exchange_is_not_correct(monkeypatch):
    """On two shards, the candidates of every shard but the first left out
    of the merge (row tiles of 128 lanes, so that each shard holds some)."""
    more = {"num_sequences": 3000}
    sound = _run("trembl4.file21", devices=["cpu", "cpu"], config_update=more)
    assert sound["correct"] is True
    add = sharding.Candidates.add

    def first_only(self, shard, vals, ids, extras=()):
        if shard.pos == 0:
            add(self, shard, vals, ids, extras)
        else:
            add(self, shard, vals[..., :0], ids[..., :0], extras)

    monkeypatch.setattr(sharding.Candidates, "add", first_only)
    res = _run("trembl4.file21", devices=["cpu", "cpu"], config_update=more)
    assert res["correct"] is False and _checks(res)["wrong_top"] > 0
