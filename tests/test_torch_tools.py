"""The port's experiment kernels and tools on the CPU against the JAX
package: the manual-staging cell kernel (B7) against
``score_bucket_pallas_cell_manual`` in interpret mode, in both state
modes (SAT lowered to 30 for int16, under the SAT rule); the P-tiles-per-
block kernel (B8, ``tools.pairbench.score_pair``) against the cell kernel
in interpret mode (JAX's ``score_pair`` has no interpret mode, and
pairbench itself checks against the cell kernel); and both tools' ``main``
at L = 32, n = 8192.  Inputs are made with numpy from seeds.
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudasw4_tpu import make_scoring_config as jax_scoring
from cudasw4_tpu.ops import sw_pallas_cell
from cudasw4_tpu_torch.ops import sw_cell
from cudasw4_tpu_torch.tools import dmabench, pairbench


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, T, L, nq, mat="blosum62"):
    rng = np.random.default_rng(seed)
    cfg = jax_scoring(mat)
    A, pad = cfg.alphabet_size, cfg.pad_code
    x = rng.integers(0, A - 1, size=(T, L, 4096)).astype(np.int8)
    lens = rng.integers(1, L + 1, size=(T, 1, 4096))
    x[np.arange(L)[None, :, None] >= lens] = pad
    tiles = np.ascontiguousarray(x.reshape(T, L, 32, 128))
    q = np.full(64, pad, np.int32)
    q[:nq] = rng.integers(0, A - 1, size=nq)
    params = np.array([nq, cfg.gop, cfg.gex, 0], np.int32)
    mat_flat = cfg.matrix.astype(np.int32).reshape(-1)
    jargs = tuple(map(jnp.asarray, (tiles, q, mat_flat, params)))
    targs = (torch.as_tensor(tiles), torch.as_tensor(q), torch.as_tensor(mat_flat), params)
    return jargs, targs


@pytest.mark.parametrize("exact", [True, False])
def test_manual_plain_equals_pallas_manual(exact, monkeypatch):
    sat = sw_cell.SAT if exact else 30
    monkeypatch.setattr(sw_pallas_cell, "SAT", sat)
    monkeypatch.setattr(sw_cell, "SAT", sat)
    sw_pallas_cell.score_bucket_pallas_cell_manual._clear_cache()
    # Each mode at its own L: traced Pallas kernels outlive _clear_cache.
    jargs, targs = _inputs(71, 3, 16 if exact else 24, 12)
    want = torch.as_tensor(np.asarray(sw_pallas_cell.score_bucket_pallas_cell_manual(
        *jargs, interpret=True, exact=exact)))
    before = (sw_cell.score_bucket_cell_manual.plain_calls,
              sw_cell.score_bucket_cell_manual.plain_calls16)
    got = sw_cell.score_bucket_cell_manual(*targs, exact=exact)
    after = (sw_cell.score_bucket_cell_manual.plain_calls,
             sw_cell.score_bucket_cell_manual.plain_calls16)
    assert after == (before[0] + exact, before[1] + (not exact))
    if exact:
        assert torch.equal(got, want)
    else:
        assert bool(sw_cell.sat_match(got, want).all())
        assert int((want >= 30).sum()) > 0
    sw_pallas_cell.score_bucket_pallas_cell_manual._clear_cache()


def test_manual_rejects_non_cell_tiles():
    _, (tiles, q, mat, params) = _inputs(73, 2, 8, 5)
    before = sw_cell.score_bucket_cell_manual.plain_calls
    with pytest.raises(ValueError):
        sw_cell.score_bucket_cell_manual(tiles.reshape(2, 8, 4096), q, mat, params)
    with pytest.raises(ValueError):
        sw_cell.score_bucket_cell_manual(tiles.reshape(2, 8, 64, 64), q, mat, params)
    assert sw_cell.score_bucket_cell_manual.plain_calls == before


@pytest.mark.parametrize("P", [2, 4])
def test_pair_plain_equals_pallas_cell(P):
    jargs, targs = _inputs(72, 4, 16, 20, "blosum62_full")
    want = torch.as_tensor(np.asarray(sw_pallas_cell.score_bucket_pallas_cell(
        *jargs, interpret=True, exact=True)))
    before = pairbench.score_pair.plain_calls
    got = pairbench.score_pair(*targs, P=P)
    assert pairbench.score_pair.plain_calls == before + 1
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        pairbench.score_pair(targs[0][:3], *targs[1:], P=P)


@pytest.mark.parametrize("tool,checks", [(dmabench, 3), (pairbench, 2)])
def test_tool_main_prints_only_ok(tool, checks):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tool.main(["32", "8192", "1", "--device", "cpu"]) == 0
    lines = buf.getvalue().splitlines()
    assert sum("[OK]" in line for line in lines) == checks
    assert not any("MISMATCH" in line for line in lines)
    assert all("GCUPS" in line or "skipped" in line for line in lines)
