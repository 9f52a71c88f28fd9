"""The readers of ``kernels.col_pass_share`` and its twin
``kernels.col_pass_share.stream`` on the col wrappers' pass counters: the
share of warp-passes run, the same under both names, and nothing off the
card, without a col launch, or on an engine without the counters."""

from __future__ import annotations

import types

import pytest

from swbench import run

CARD = types.SimpleNamespace(device_name="NVIDIA H100 80GB HBM3")
NAMES = ("kernels.col_pass_share", "kernels.col_pass_share.stream")


@pytest.fixture
def passes(monkeypatch):
    """Set the B3, B5 and B6 wrappers' counters: three (warp, bucket)
    pairs, or None to take the counters away."""
    from cudasw4_tpu_torch.ops import sw_col

    wrappers = (sw_col.score_bucket_col, sw_col.score_bucket_col_flat,
                sw_col.score_bucket_col_flat_fused)

    def set_passes(counts):
        for w, c in zip(wrappers, counts or (None,) * 3):
            for name, v in zip(("col_warp_passes", "col_bucket_passes"), c or (None, None)):
                if v is None:
                    monkeypatch.delattr(w, name)
                else:
                    monkeypatch.setattr(w, name, v)

    return set_passes


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("counts,want", [
    (((60, 100), (30, 50), (0, 0)), 60.0),
    (((40, 40), (0, 0), (10, 10)), 100.0),
    (((0, 0), (0, 0), (0, 0)), None),
    (None, None),
])
def test_col_pass_share_reads_the_pass_counters(passes, name, counts, want):
    passes(counts)
    got = run.read_metric(name, CARD)
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("name", NAMES)
def test_col_pass_share_reads_nothing_off_the_card(passes, name):
    passes(((60, 100), (30, 50), (0, 0)))
    assert run.read_metric(name, types.SimpleNamespace(device_name="cpu")) is None
