"""The reader of ``kernels.s16x2_share`` on the cell wrappers' slot
counters: the share of exact cell slots in s16x2 lanes, and nothing off
the card, without an exact cell slot, or on an engine without the
counters."""

from __future__ import annotations

import types

import pytest

from swbench import run

CARD = types.SimpleNamespace(device_name="NVIDIA H100 80GB HBM3")


@pytest.fixture
def slots(monkeypatch):
    """Set the B1 and B4 wrappers' counters: ((s16x2, int32), (s16x2,
    int32)), or None to take the counters away."""
    from cudasw4_tpu_torch.ops import sw_cell

    wrappers = (sw_cell.score_bucket_cell, sw_cell.score_bucket_cell_batch)

    def set_slots(counts):
        for w, c in zip(wrappers, counts or (None, None)):
            for name, v in zip(("s16x2_slots", "int32_slots"), c or (None, None)):
                if v is None:
                    monkeypatch.delattr(w, name)
                else:
                    monkeypatch.setattr(w, name, v)

    return set_slots


@pytest.mark.parametrize("counts,want", [
    (((30, 0), (140, 0)), 100.0),
    (((30, 10), (140, 20)), 85.0),
    (((0, 7), (0, 0)), 0.0),
    (((0, 0), (0, 0)), None),
    (None, None),
])
def test_s16x2_share_reads_the_slot_counters(slots, counts, want):
    slots(counts)
    got = run.read_metric("kernels.s16x2_share", CARD)
    assert got == (None if want is None else pytest.approx(want))


def test_s16x2_share_reads_nothing_off_the_card(slots):
    slots(((30, 0), (140, 0)))
    assert run.read_metric("kernels.s16x2_share", types.SimpleNamespace(device_name="cpu")) is None
