"""The harness on the card at a small size: the engine's CUDA kernels give
a correct run, and the int16 control (SAT lowered below the longest entry's
own hit) does not.  Run on a machine with a card:
``python -m pytest swbench/tests/test_swbench_card.py``."""

from __future__ import annotations

import pytest
from conftest import tiny

from swbench import control, run


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["sprot.file21", "sprot.interactive", "trembl.interactive"])
@pytest.mark.parametrize("with_control", [False, True])
def test_cell_on_the_card(cell, with_control, card, monkeypatch):
    from cudasw4_tpu_torch.db import packing
    from cudasw4_tpu_torch.ops import sw_cell

    monkeypatch.setattr(packing, "CELL_SPEEDUP", 1000.0)  # cell tiles at this size
    if with_control:
        monkeypatch.setattr(sw_cell, "SAT", 200)
        monkeypatch.setattr(control, "INT16_MAX", 200)
    bench, c, config, traffic = tiny(cell)
    out = run.run_cell(bench, c, config, traffic, 2**31 + 11, 0.05, True, [card],
                       patch=control.int16_control if with_control else None)
    res = out["result"]
    assert res["correct"] is (not with_control)
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
