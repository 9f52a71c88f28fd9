"""CUDA kernels of cudasw4_tpu_torch against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and skips without one.  Tolerance:
exact — scores and carried DP state are integers.  The file imports no
JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from cudasw4_tpu_torch import make_scoring_config
from cudasw4_tpu_torch.db.packing import PackedBucket, PackedDB
from cudasw4_tpu_torch.engine import SearchEngine
from cudasw4_tpu_torch.ops import sw_cell, sw_col, sw_row
from cudasw4_tpu_torch.ops.oracle import sw_score_scalar

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _tiles(rng, shape, pad, nreal, A):
    """Random subject codes in [0, A-1) with ragged real lengths; positions
    past each subject's length and lanes past ``nreal`` carry ``pad``."""
    T, L = shape[0], shape[1]
    ns = int(np.prod(shape[2:]))
    x = rng.integers(0, A - 1, size=(T, L, ns)).astype(np.int8)
    lens = rng.integers(1, L + 1, size=(T, ns))
    x[np.arange(L)[None, :, None] >= lens[:, None, :]] = pad
    flat = x.transpose(0, 2, 1).reshape(T * ns, L)
    flat[nreal:] = pad
    x = flat.reshape(T, ns, L).transpose(0, 2, 1)
    return np.ascontiguousarray(x).reshape(shape)


def _query(rng, nq, cap, pad, A):
    q = np.full(cap, pad, np.int32)
    q[:nq] = rng.integers(0, A - 1, size=nq)
    return q


MATS = ["blosum62", "blosum62_full"]


@pytest.mark.parametrize("mat", MATS)
def test_cell_kernel_equals_plain(dev, mat):
    rng = np.random.default_rng(11)
    cfg = make_scoring_config(mat)
    A, pad = cfg.alphabet_size, cfg.pad_code
    tiles = _tiles(rng, (2, 64, 32, 128), pad, 2 * 4096 - 100, A)
    q = _query(rng, 53, 256, pad, A)
    m = torch.as_tensor(cfg.matrix.astype(np.int32).reshape(-1))
    params = (53, cfg.gop, cfg.gex, 56)
    want = sw_cell.score_bucket_cell_plain(torch.as_tensor(tiles), torch.as_tensor(q), m, params)
    before = sw_cell.score_bucket_cell.launches
    got = sw_cell.score_bucket_cell(
        torch.as_tensor(tiles).to(dev), torch.as_tensor(q).to(dev), m.to(dev), params
    )
    assert sw_cell.score_bucket_cell.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("mat", MATS)
@pytest.mark.parametrize("L,NS", [(37, 128), (40, 256)])
def test_row_kernel_equals_plain(dev, mat, L, NS):
    rng = np.random.default_rng(12)
    cfg = make_scoring_config(mat)
    A, pad = cfg.alphabet_size, cfg.pad_code
    tiles = _tiles(rng, (3, L, NS), pad, 3 * NS - 5, A)
    q = _query(rng, 29, 64, pad, A)
    m = torch.as_tensor(cfg.matrix.astype(np.int32).reshape(-1))
    params = (29, cfg.gop, cfg.gex, 32)
    want = sw_row.score_bucket_row_plain(torch.as_tensor(tiles), torch.as_tensor(q), m, params)
    got = sw_row.score_bucket_row(
        torch.as_tensor(tiles).to(dev), torch.as_tensor(q).to(dev), m.to(dev), params
    )
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("mat", MATS)
def test_col_kernel_carry_equals_plain(dev, mat):
    """One chunk emitting its state, then a chunk taking it and emitting
    again: scores and the carried H/F rows equal the plain version's."""
    rng = np.random.default_rng(13)
    cfg = make_scoring_config(mat)
    A, pad = cfg.alphabet_size, cfg.pad_code
    tiles = _tiles(rng, (2, 256, 32, 128), pad, 2 * 4096, A)
    m = torch.as_tensor(cfg.matrix.astype(np.int32).reshape(-1))
    t_cpu, t_dev = torch.as_tensor(tiles), torch.as_tensor(tiles).to(dev)
    q1 = _query(rng, 40, 64, pad, A)
    q2 = _query(rng, 21, 64, pad, A)
    p1 = (40, cfg.gop, cfg.gex, 0)
    p2 = (24, cfg.gop, cfg.gex, 0)
    s1w, st1w = sw_col.score_bucket_col_plain(t_cpu, torch.as_tensor(q1), m, p1, emit_state=True)
    s1, st1 = sw_col.score_bucket_col(
        t_dev, torch.as_tensor(q1).to(dev), m.to(dev), p1, emit_state=True
    )
    assert torch.equal(s1.cpu(), s1w)
    assert torch.equal(st1[0].cpu(), st1w[0]) and torch.equal(st1[1].cpu(), st1w[1])
    s2w, st2w = sw_col.score_bucket_col_plain(
        t_cpu, torch.as_tensor(q2), m, p2, state_in=st1w, emit_state=True
    )
    s2, st2 = sw_col.score_bucket_col(
        t_dev, torch.as_tensor(q2).to(dev), m.to(dev), p2,
        state_in=st1, take_init=True, emit_state=True,
    )
    assert torch.equal(s2.cpu(), s2w)
    assert torch.equal(st2[0].cpu(), st2w[0]) and torch.equal(st2[1].cpu(), st2w[1])
    s3 = sw_col.score_bucket_col(
        t_dev, torch.as_tensor(q2).to(dev), m.to(dev), p2, state_in=st1, take_init=True
    )
    assert torch.equal(s3.cpu(), s2w)


def test_col_any_query_tile_groups_match_oracle(dev, monkeypatch):
    """A query of three NQC chunks, one-tile groups, against the scalar
    oracle on a sample of subjects."""
    monkeypatch.setattr(sw_col, "NQC", 32)
    rng = np.random.default_rng(14)
    cfg = make_scoring_config("blosum62")
    A, pad = cfg.alphabet_size, cfg.pad_code
    tiles = _tiles(rng, (2, 128, 32, 128), pad, 2 * 4096, A)
    codes = rng.integers(0, 20, size=77).astype(np.int8)
    m = torch.as_tensor(cfg.matrix.astype(np.int32).reshape(-1))
    got = sw_col.score_bucket_col_any_query(
        torch.as_tensor(tiles).to(dev), codes, m.to(dev), cfg.gop, cfg.gex,
        pad=pad, temp_bytes=1,
    ).cpu().reshape(-1)
    flat = tiles.reshape(2, 128, 4096).transpose(0, 2, 1).reshape(-1, 128)
    for k in rng.choice(len(flat), size=12, replace=False):
        want = sw_score_scalar(codes, flat[k], cfg.matrix, cfg.gop, cfg.gex)
        assert int(got[k]) == want


def test_engine_cuda_equals_cpu(dev):
    """The engine on the card and on the CPU give the same top hits on a
    database with one bucket of each kind."""
    rng = np.random.default_rng(15)
    cfg = make_scoring_config("blosum62")
    pad = cfg.pad_code
    buckets = []
    base = 0
    for L, kind, ns in ((32, "row", 128), (64, "cell", 4096), (256, "col", 4096)):
        cnt = ns - 3
        tiles = _tiles(rng, (1, L, ns) if kind == "row" else (1, L, 32, 128), pad, cnt, 21)
        sidx = np.full((1, ns), -1, np.int32)
        sidx[0, :cnt] = np.arange(base, base + cnt)
        buckets.append(PackedBucket(L=L, NS=ns, tiles=tiles, seq_index=sidx,
                                    lengths=(sidx >= 0).astype(np.int32) * L, kernel=kind))
        base += cnt
    packed = PackedDB(buckets=buckets, num_sequences=base, total_real_chars=base)
    queries = [rng.integers(0, 20, size=n).astype(np.int8) for n in (17, 120)]
    results = []
    for device in ("cpu", "cuda"):
        eng = SearchEngine(scoring=cfg, num_top=25, device=device)
        eng.set_database(None, packed=packed)
        results.append([(r.scores, r.reference_ids) for r in eng.scan_many(queries)])
    assert results[0] == results[1]


def test_wrapper_rejects_bad_arguments(dev):
    m = torch.zeros(441, dtype=torch.int32, device=dev)
    q = torch.zeros(16, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        sw_row.score_bucket_row(torch.zeros((1, 8, 128), dtype=torch.int32, device=dev), q, m, (4, -11, -1, 8))
    with pytest.raises(ValueError):
        sw_cell.score_bucket_cell(torch.zeros((1, 8, 32, 128), dtype=torch.int8, device=dev), q, m, (17, -11, -1, 24))
