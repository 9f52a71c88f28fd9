"""``swbench.percard`` on a hand-made trace: each card's time in ``sw_*``
kernels within the window, and the same over the window's queries."""

from __future__ import annotations

import json

import pytest

from swbench import percard, run, trace as tracing


def test_percard_reads_each_cards_sw_time(monkeypatch, capsys):
    tr = tracing.Trace(window_ns=(0, 100))
    tr.kernels[0] += [(10, 30, "sw_col_kernel"), (25, 40, "sw_cell16_kernel"), (40, 50, "copy")]
    tr.kernels[1] += [(50, 200, "sw_col_flat_kernel")]
    monkeypatch.setattr(tracing, "from_profiler", lambda prof: tr)

    def fake_main(argv):
        assert argv[-2:] == ["--trace", "1"]
        tracing.from_profiler(None)
        print(json.dumps({"attempted": 5}))
        return 0

    monkeypatch.setattr(run, "main", fake_main)
    assert percard.main(["--workload", "sprot.file21"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0]) == {"attempted": 5}
    last = json.loads(lines[-1])
    assert last["queries"] == 5
    assert last["sw_s"] == {"0": pytest.approx(30e-9), "1": pytest.approx(50e-9)}
    assert last["sw_ms_per_query"] == {"0": pytest.approx(6e-6), "1": pytest.approx(10e-6)}
    assert tracing.from_profiler(None) is tr  # the patch is undone


def test_percard_passes_a_failed_run_on(monkeypatch):
    monkeypatch.setattr(run, "main", lambda argv: 2)
    assert percard.main(["--workload", "trembl4.file21"]) == 2
