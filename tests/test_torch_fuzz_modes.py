"""Cross-mode fuzz of the port (the counterpart of tests/test_fuzz_modes.py):
random databases and queries scored through every entry point of the
port's engine must agree with its own resident scan and with the JAX
engine's, including edge shapes (empty and 1-residue queries, length-1
subjects, duplicate subjects for the tie rule).

The entry points: single ``scan``, ``scan_many`` and ``scan_batch`` on the
resident database; a streamed ``scan_batch`` and ``scan_many``; a mesh of
two shards, resident and streamed.  ``fuzz_trial`` holds them against the
resident scan on any device (tests/test_torch_cuda.py runs it on the
card); the test here also holds the resident scan against the JAX
engine's.  Inputs are made with numpy from seeds (three trials, the JAX
test's).  Tolerance: exact (scores, ids and order).
"""

import numpy as np
import pytest
import torch

from cudasw4_tpu_torch.db.format import DBData
from cudasw4_tpu_torch.engine import SearchEngine
from cudasw4_tpu_torch.parallel.sharding import make_mesh

#: The JAX test's query lengths: empty, one residue, and three more.
QUERY_LENGTHS = (0, 1, 17, 44, 63)


def random_db_fields(rng, n):
    """The JAX test's random database as DBData fields: ``n`` subjects of
    1-89 residues, three of them of length 1, sorted by length; subject 5
    a copy of subject 2's start, so that equal scores meet the tie rule."""
    lengths = rng.integers(1, 90, n)
    lengths[rng.integers(0, n, 3)] = 1
    lengths = np.sort(lengths).astype(np.int32)
    padded = (lengths + 3) // 4 * 4
    offsets = np.concatenate([[0], np.cumsum(padded)]).astype(np.uint64)
    chars = np.full(int(offsets[-1]), 20, np.int8)
    for i, ln in enumerate(lengths):
        chars[int(offsets[i]): int(offsets[i]) + ln] = rng.integers(0, 20, ln)
    if n >= 6:
        a, b = int(offsets[2]), int(offsets[3])
        span = min(b - a, int(offsets[5] + lengths[5]) - int(offsets[5]))
        chars[int(offsets[5]): int(offsets[5]) + span] = chars[a: a + span]
    return dict(chars=chars, offsets=offsets, lengths=lengths, headers=np.zeros(0, np.uint8),
                header_offsets=np.zeros(n + 1, np.uint64))


def _results(rs):
    return [(r.scores, r.reference_ids) for r in rs]


def fuzz_trial(trial: int, device: str):
    """One trial on ``device`` ("cpu" or "cuda"): every entry point against
    the resident single scan.  Returns (fields, queries, the resident
    scan's (scores, ids) per query)."""
    trng = np.random.default_rng(1000 + trial)
    fields = random_db_fields(trng, 150)
    db = DBData(**fields)
    queries = [trng.integers(0, 20, int(q)).astype(np.int8) for q in QUERY_LENGTHS]
    base = SearchEngine(num_top=6, qcap=64, device=device)
    base.set_database(db)
    want = _results(base.scan(q) for q in queries)
    assert _results(base.scan_many(queries)) == want, trial
    assert _results(base.scan_batch(queries)) == want, trial

    stream = SearchEngine(num_top=6, qcap=64, max_device_bytes=1024, stream_chunk_bytes=2048,
                          device=device)
    stream.QB_MAX = 3
    stream.set_database(db)
    assert stream.streaming
    assert _results(stream.scan_batch(queries[:3])) == want[:3], trial
    assert _results(stream.scan_many(queries)) == want, trial

    for budget in (None, 1024):
        mesh_eng = SearchEngine(num_top=6, qcap=64, mesh=make_mesh([device] * 2),
                                max_device_bytes=budget, stream_chunk_bytes=2048)
        mesh_eng.set_database(db)
        assert mesh_eng.streaming == (budget is not None)
        assert _results(mesh_eng.scan(q) for q in queries) == want, (trial, budget)
        assert _results(mesh_eng.scan_many(queries)) == want, (trial, budget)
    return fields, queries, want


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("trial", range(3))
def test_fuzz_modes_agree_with_resident_and_jax(trial):
    from cudasw4_tpu.db.format import DBData as JaxDBData
    from cudasw4_tpu.engine import SearchEngine as JaxEngine

    fields, queries, want = fuzz_trial(trial, "cpu")
    jeng = JaxEngine(num_top=6, qcap=64)
    jeng.set_database(JaxDBData(**fields))
    assert _results(jeng.scan(q) for q in queries) == want, trial
    scores, ids = want[3]
    assert len(scores) == 6 and ids == [i for _, i in sorted(zip((-s for s in scores), ids))]
