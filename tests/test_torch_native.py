"""The port's native IO library (cudasw4_tpu_torch/native: the C++ FASTA
parser, the tile packer, the b32/b21 transfer packers) against the JAX
package's Python paths on the same inputs, and the port's ``makedb`` with
and without the library against the JAX package's ``makedb``.

The JAX package's native switch is held off (``CUDASW4_TPU_NATIVE=0``), so
its Python reader and packers are the reference.  Tolerance: exact — bytes
and arrays are compared as they are.
"""

import gzip
import os

import numpy as np
import pytest

from cudasw4_tpu.constants import encode as jax_encode
from cudasw4_tpu.constants import pad_length
from cudasw4_tpu.db import format as jfmt
from cudasw4_tpu.db import packing as jpacking
from cudasw4_tpu.db.fasta import read_sequences as jax_read
from cudasw4_tpu.ops import pack5 as jpack5
from cudasw4_tpu_torch import native
from cudasw4_tpu_torch.db import format as tfmt
from cudasw4_tpu_torch.db import packing as tpacking
from cudasw4_tpu_torch.ops import pack5 as tpack5

AAS = "ARNDCQEGHILKMFPSTWYV"
DB_FILES = ("metadata", "0chars", "0offsets", "0lengths", "0headers", "0headeroffsets",
            "0metadata")


@pytest.fixture(autouse=True)
def _jax_python_paths(monkeypatch):
    monkeypatch.setenv("CUDASW4_TPU_NATIVE", "0")
    monkeypatch.delenv("CUDASW4_TPU_TORCH_NATIVE", raising=False)
    assert native.get_lib() is not None, native.build_error


def _jax_reference(path):
    """The JAX package's Python reader: (chars, offsets, lengths, headers)."""
    chars, offsets, lengths, headers = [], [0], [], []
    for rec in jax_read(path):
        padded = rec.sequence + " " * (pad_length(len(rec.sequence)) - len(rec.sequence))
        chars.append(jax_encode(padded))
        offsets.append(offsets[-1] + len(padded))
        lengths.append(len(rec.sequence))
        headers.append(rec.header.encode("latin-1"))
    return (np.concatenate(chars) if chars else np.zeros(0, np.int8),
            np.asarray(offsets, np.int64), np.asarray(lengths, np.int32), headers)


def _write_plain(path, rng):
    with open(path, "w") as f:
        for i in range(30):
            seq = "".join(AAS[c] for c in rng.integers(0, 20, int(rng.integers(1, 200))))
            f.write(f">id{i} some description {i}\n")
            for s in range(0, len(seq), 60):
                f.write(seq[s:s + 60] + "\n")


def _write_gzip_crlf(path, rng):
    with gzip.open(path, "wt", newline="") as f:
        f.write(">h1 desc\r\nMKV\r\nLAA\r\n\r\n>h2\nWWxzj*\n>empty\n>h4\nACDE\n")


def _write_fastq(path, rng):
    with open(path, "w") as f:
        f.write("@r1 desc\nMKVL\n+\n!!!!\n@r2\nWWAA\nCC\n+r2\n!!!!!!\n@r3\nV\n+\n!\n")


def _write_long(path, rng):
    seq = "".join(AAS[c] for c in rng.integers(0, 20, 200_000))  # past a 64 KB line buffer
    with open(path, "w") as f:
        f.write(f">long protein\n{seq}\n>tail\nWW\n")


INPUTS = {"plain.fa": _write_plain, "multi_crlf.fa.gz": _write_gzip_crlf,
          "reads.fq": _write_fastq, "long.fa": _write_long}


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_parse_equals_jax_reader(tmp_path, name):
    path = str(tmp_path / name)
    INPUTS[name](path, np.random.default_rng(11))
    got, want = native.parse_fasta_native(path), _jax_reference(path)
    for a, b in zip(got[:3], want[:3]):
        assert np.array_equal(a, b)
    assert got[3] == want[3]
    blob, hoffs = native.parse_fasta_native(path, header_blob=True)[3]
    assert bytes(blob) == b"".join(want[3]) and hoffs[-1] == len(blob)


def test_parse_missing_file_raises(tmp_path):
    with pytest.raises(ValueError):
        native.parse_fasta_native(str(tmp_path / "nope.fa"))
    with pytest.raises(ValueError):
        list(native.stream_fasta_native(str(tmp_path / "nope.fa")))


def test_stream_batches_equal_jax_reader(tmp_path):
    path = str(tmp_path / "s.fa")
    _write_plain(path, np.random.default_rng(12))
    batches = list(native.stream_fasta_native(path, chunk_chars=300))
    assert len(batches) > 3
    want = _jax_reference(path)
    assert np.array_equal(np.concatenate([b[0] for b in batches]), want[0])
    assert [n for b in batches for n in b[2]] == list(want[2])
    assert [h for b in batches for h in b[3]] == want[3]
    for chars, offsets, lengths, _ in batches:
        assert offsets[0] == 0 and offsets[-1] == len(chars) and len(offsets) == len(lengths) + 1


def _make_dbs(tmp_path, n=400, seed=13, dense=0):
    """A FASTA of ``n`` sequences of 1-899 aa and ``dense`` more of 33-48
    aa (enough for a cell bucket), and the JAX package's database of it."""
    rng = np.random.default_rng(seed)
    lengths = np.concatenate([rng.integers(1, 900, n), rng.integers(33, 49, dense)])
    fa = str(tmp_path / "db.fa")
    with open(fa, "w") as f:
        for i, ln in enumerate(lengths):
            seq = "".join(AAS[c] for c in rng.integers(0, 20, int(ln)))
            f.write(f">s{i} protein {i}\n{seq}\n")
    jfmt.make_db(fa, str(tmp_path / "jax"))
    return fa, str(tmp_path / "jax")


@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("use_native", ["1", "0"])
def test_makedb_with_and_without_native_equals_jax(tmp_path, monkeypatch, capped, use_native):
    fa, jprefix = _make_dbs(tmp_path)
    monkeypatch.setenv("CUDASW4_TPU_TORCH_NATIVE", use_native)
    prefix = str(tmp_path / "port")
    if capped:
        tfmt.make_db_capped(fa, prefix, 0)
    else:
        tfmt.make_db(fa, prefix)
    for f in DB_FILES:
        with open(prefix + f, "rb") as a, open(jprefix + f, "rb") as b:
            assert a.read() == b.read(), f


@pytest.mark.parametrize("pad", [20, 25, 0])
def test_pack_db_native_equals_jax(tmp_path, pad):
    _, jprefix = _make_dbs(tmp_path, n=500, seed=14, dense=3000)
    got = tpacking.pack_db(tfmt.load_db(jprefix), pad_code=pad)
    want = jpacking.pack_db(jfmt.load_db(jprefix), pad_code=pad, use_native=False)
    assert [(b.L, b.NS, b.kernel) for b in got.buckets] == \
        [(b.L, b.NS, b.kernel) for b in want.buckets]
    assert {b.kernel for b in got.buckets} >= {"row", "cell"}
    for x, y in zip(got.buckets, want.buckets):
        assert np.array_equal(x.tiles, y.tiles)
        assert np.array_equal(x.seq_index, y.seq_index)
        assert np.array_equal(x.lengths, y.lengths)


def test_pack_bucket_native_slab_and_ns_guard(tmp_path):
    _, jprefix = _make_dbs(tmp_path, n=300, seed=15)
    db = tfmt.load_db(jprefix)
    lengths = np.asarray(db.lengths, np.int32)
    offsets = np.asarray(db.offsets, np.int64)
    got = native.pack_bucket_native(db.chars, offsets, lengths, 10, 200, 1024, 128)
    want = tpacking._pack_slab(np.asarray(db.chars), offsets, lengths.astype(np.int64),
                               10, 200, 1024, 128, 20)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert native.pack_bucket_native(db.chars, offsets, lengths, 0, 10, 64, 96) is None


@pytest.mark.parametrize("codec", ["b32", "b21"])
def test_transfer_pack_native_equals_jax(codec):
    rng = np.random.default_rng(16)
    tiles = rng.integers(0, 21, size=(5, 37, 32, 4)).astype(np.int8)
    port, jax = ((tpack5.pack5, jpack5.pack5) if codec == "b32"
                 else (tpack5.pack21, jpack5.pack21))
    assert np.array_equal(port(tiles, slab=2), jax(tiles, slab=2))
    bad = tiles.copy()
    bad[3, 1, 2, 0] = 32 if codec == "b32" else 21
    for fn in (port, jax):
        with pytest.raises(ValueError):
            fn(bad)


def test_native_switch_and_build_dir(monkeypatch):
    assert native.get_lib() is not None
    assert native.library_path().parent == native.BUILD_DIR
    assert not os.path.exists(os.path.join(os.path.dirname(native.__file__), "libtpusw_io.so"))
    monkeypatch.setenv("CUDASW4_TPU_TORCH_NATIVE", "0")
    assert native.get_lib() is None
    assert native.parse_fasta_native(__file__) is None
    assert native.pack_codes_native(np.zeros((1, 6), np.int8), np.zeros((1, 1), np.int32),
                                    "b32") is False
