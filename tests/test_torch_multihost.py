"""Two processes of the port's tools/run_multihost.py on the CPU, joined
by gloo into one mesh of four shards (two a process), against the JAX
package's single-process search of the same database
(tests/test_multihost.py runs the JAX package's two-process cluster).

Rank 0 prints its hits to standard output and rank 1 the same lines to
its standard error: the lines of each must equal the JAX engine's hits on
one device, resident and streamed.  The processes meet at a file store of
the test's own (``--coordinator file://...``), so no port is chosen.  The
streamed run with a tile store for each process (``--packCache``) leaves
two per-host stores, each with only its own rows, sparse on disk.  Tolerance: the
output lines byte for byte, the run's "Total" timing line aside.
"""

import itertools
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from cudasw4_tpu.db.format import load_db as jax_load_db
from cudasw4_tpu.engine import SearchEngine as JaxEngine
from cudasw4_tpu_torch.cli import makedb
from cudasw4_tpu_torch.db.fasta import read_sequences, write_fasta
from cudasw4_tpu_torch.db.format import load_db
from cudasw4_tpu_torch.db.packing import load_packed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AAS = "ARNDCQEGHILKMFPSTWYV"


_RENDEZVOUS = itertools.count()


def _hit_lines(text: str) -> list:
    """run_multihost's hit and "Total" lines, without anything else a
    process logs to its standard error."""
    return [line for line in text.splitlines()
            if line.startswith(("# ", "Total ")) or re.match(r"\d+\t", line)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A database of 3,200 sequences of 5-80 aa (several tiles a bucket),
    three queries, and the JAX engine's printed hits on one device."""
    d = tmp_path_factory.mktemp("multihost")
    rng = np.random.default_rng(2024)
    write_fasta(str(d / "db.fa"), [
        (f"p{i}", "".join(AAS[c] for c in rng.integers(0, 20, int(n))))
        for i, n in enumerate(rng.integers(5, 80, size=3200))])
    write_fasta(str(d / "q.fa"), [
        (f"q{i}", "".join(AAS[c] for c in rng.integers(0, 20, n))) for i, n in enumerate((30, 12, 55))])
    assert makedb.run([str(d / "db.fa"), str(d / "db")]) == 0
    jdb = jax_load_db(str(d / "db"))
    jeng = JaxEngine(num_top=10)
    jeng.set_database(jdb)
    records = list(read_sequences(str(d / "q.fa")))
    lines = []
    for rec, res in zip(records, jeng.scan_many(r.sequence for r in records)):
        lines.append(f"# {rec.header}")
        lines += [f"{i}\t{s}\t{jeng.get_reference_length(r)}\t{jeng.get_reference_header(r)}\t{r}"
                  for i, (s, r) in enumerate(zip(res.scores, res.reference_ids))]
    return d, lines


def _run_two(d, *extra):
    """Two gloo processes of run_multihost, two CPU shards each; returns
    each one's hit lines (rank 0's standard output, rank 1's standard
    error) without the timing line."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    coordinator = f"file://{d / f'rendezvous{next(_RENDEZVOUS)}'}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "cudasw4_tpu_torch.tools.run_multihost",
             "--db", str(d / "db"), "--query", str(d / "q.fa"), "--device", "cpu",
             "--shards", "2", "--coordinator", coordinator, "--num-processes", "2",
             "--process-id", str(pid), *(a.format(pid=pid) for a in extra)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=str(d),
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"run_multihost failed:\n{out}\n{err}"
        assert p is procs[0] or not out, "only rank 0 prints to standard output"
        lines = out.splitlines() if p is procs[0] else _hit_lines(err)
        assert lines[-1].startswith("Total ") and lines[-1].endswith(" GCUPS")
        outs.append(lines[:-1])
    return outs


def test_two_gloo_processes_print_the_jax_result(setup):
    d, want = setup
    assert _run_two(d) == [want, want]


def test_two_gloo_processes_streamed_with_per_host_stores(setup):
    """Each shard's budget far below the database: every pass streams, and
    each process packs only its shards' rows into its own store."""
    d, want = setup
    out = _run_two(d, "--maxGpuMem", "1", "--maxBatchBytes", "16K", "--packCache",
                   str(d / "host{pid}.npz"))
    assert out == [want, want]
    db = load_db(str(d / "db"))
    stores = [load_packed(str(d / f"host{pid}.npz"), db.num_sequences, int(db.lengths.sum()),
                          need_ranges="any") for pid in range(2)]
    for pid, st in enumerate(stores):
        assert st.tile_ranges is not None
        tiles = str(d / f"host{pid}.npz.tiles")
        assert os.stat(tiles).st_blocks * 512 < os.path.getsize(tiles)
    for r0, r1, b in zip(stores[0].tile_ranges, stores[1].tile_ranges, stores[0].buckets):
        assert sorted(r0 + r1)[0][0] == 0 and sum(e - a for a, e in r0 + r1) == b.num_tiles
