"""Shared pieces of the harness's tests: a cell cut to a size the CPU
runs in seconds, and the ``cuda`` marker of the tests that need a card."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


def tiny(cell_name: str):
    """(bench, cell, config, traffic) of cell ``<config>.<traffic>`` (of
    BENCHMARK.json, or made from the two files: a configuration of
    ``configs/`` or of the tests' ``data/``) cut to 300 entries of at
    most 120 residues, with 3 query-file members or 5 quantiles, and a
    short reference budget."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config_name, traffic_name = cell_name.split(".")
    cell = {c["name"]: c for c in bench["workloads"]}.get(
        cell_name, {"name": cell_name, "config": config_name, "traffic": traffic_name})
    path = ROOT / "swbench" / "configs" / f"{config_name}.json"
    if not path.is_file():  # a configuration no cell uses yet
        path = Path(__file__).resolve().parent / "data" / f"{config_name}.json"
    config = json.loads(path.read_text())
    config.update(num_sequences=300, median=40, sigma=0.5, max_length=120, check_residues=60)
    if config["placement"] == "streamed":
        config.update(max_device_bytes=4_420_000, stream_chunk_bytes=16 << 10)
    traffic = json.loads((ROOT / "swbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    q = traffic["queries"]
    if "member_lengths" in q:
        q["member_lengths"] = [20, 33, 50]
    if "quantiles" in q:
        q["quantiles"] = 5
    return bench, cell, config, traffic


@pytest.fixture
def card():
    """The first CUDA card; skips the test without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
