"""On-disk database format, binary-compatible with the reference (the
port's counterpart of cudasw4_tpu/db/format.py).

A database is a global info file plus one chunk (chunk 0):

* ``<prefix>metadata``            empty global-info marker
* ``<prefix>0chars``              encoded sequences (0..20), each padded to x4
* ``<prefix>0offsets``            uint64 [n+1] char offsets
* ``<prefix>0lengths``            int32 [n] unpadded lengths, ascending
* ``<prefix>0headers``            concatenated raw header bytes
* ``<prefix>0headeroffsets``      uint64 [n+1]
* ``<prefix>0metadata``           int32 numPartitions, int32 boundaries[],
                                  uint64 numSequencesPerPartition[]

Layout and semantics mirror the reference's src/makedb.cpp:183-276 and
src/dbdata.cpp:46-116, so the files this module writes are byte-identical
to the JAX package's ``makedb`` and the reference's, and either can load
the other's.  The loader ignores the persisted chunk metadata and
recomputes partitions from the sorted lengths, like the reference.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Iterable

import numpy as np

from ..constants import encode, pad_length
from .fasta import read_sequences

# Compile-time limits of the reference (src/config.hpp:20-30).
MAX_SEQUENCES_IN_DB = 2**31 - 2
MAX_SEQUENCE_LENGTH = 2**31 - 133

I32_MAX = 2**31 - 1

#: Reference length-partition boundaries (src/length_partitions.hpp:75-113).
#: Only used for the compatibility metadata file; the engine buckets
#: independently.
LENGTH_PARTITION_BOUNDARIES = [
    48, 64, 80, 96, 112, 128, 144, 160, 176, 192, 208, 224, 240, 256,
    288, 320, 352, 384, 416, 448, 480, 512, 576, 640, 704, 768, 832,
    896, 960, 1024, 1088, 1152, 1216, 1280, 8000, I32_MAX - 1,
]


def partition_histogram(sorted_lengths: np.ndarray, boundaries=None) -> np.ndarray:
    """#sequences per length partition; length k in partition i iff
    boundaries[i-1] < k <= boundaries[i]."""
    if boundaries is None:
        boundaries = LENGTH_PARTITION_BOUNDARIES
    edges = np.asarray(boundaries, dtype=np.int64)
    pos = np.searchsorted(sorted_lengths, edges + 1, side="left")
    pos = np.concatenate([[0], pos])
    return np.diff(pos).astype(np.uint64)


class LoadDBError(Exception):
    pass


@dataclass
class DBData:
    """A loaded (memory-mapped or in-memory) database chunk."""

    chars: np.ndarray  # int8 [total_padded_chars]
    offsets: np.ndarray  # uint64 [n+1]
    lengths: np.ndarray  # int32 [n], ascending
    headers: np.ndarray  # uint8 [total_header_chars]
    header_offsets: np.ndarray  # uint64 [n+1]

    @property
    def num_sequences(self) -> int:
        return len(self.lengths)

    @property
    def num_chars(self) -> int:
        """Total number of *real* residues (excludes padding)."""
        return int(self.lengths.astype(np.int64).sum())

    @property
    def num_padded_chars(self) -> int:
        return len(self.chars)

    def get_header(self, i: int) -> str:
        a, b = int(self.header_offsets[i]), int(self.header_offsets[i + 1])
        return bytes(self.headers[a:b]).decode("latin-1", errors="replace")

    def get_sequence(self, i: int) -> np.ndarray:
        off = int(self.offsets[i])
        return self.chars[off : off + int(self.lengths[i])]


def _chunk_files(prefix: str) -> dict[str, str]:
    chunk = prefix + "0"
    return {
        "chars": chunk + "chars",
        "offsets": chunk + "offsets",
        "lengths": chunk + "lengths",
        "headers": chunk + "headers",
        "headeroffsets": chunk + "headeroffsets",
        "metadata": chunk + "metadata",
    }


def load_db(prefix: str, mmap: bool = True) -> DBData:
    """Load a database written by ``make_db`` or the reference ``makedb``."""
    if not os.path.exists(prefix + "metadata"):
        raise LoadDBError(f"missing global metadata file: {prefix}metadata")
    files = _chunk_files(prefix)
    for key in ("chars", "offsets", "lengths", "headers", "headeroffsets"):
        if not os.path.exists(files[key]):
            raise LoadDBError(f"missing db file: {files[key]}")

    def _load(path, dtype):
        if mmap and os.path.getsize(path) > 0:
            return np.memmap(path, dtype=dtype, mode="r")
        return np.fromfile(path, dtype=dtype)

    db = DBData(
        chars=_load(files["chars"], np.int8),
        offsets=_load(files["offsets"], np.uint64),
        lengths=_load(files["lengths"], np.int32),
        headers=_load(files["headers"], np.uint8),
        header_offsets=_load(files["headeroffsets"], np.uint64),
    )
    n = db.num_sequences
    if len(db.offsets) != n + 1 or len(db.header_offsets) != n + 1:
        raise LoadDBError(f"inconsistent db files for prefix {prefix}")
    return db


def _write_permuted_stream(f, data, starts, spans_s, block_chars=8 << 20):
    """Write ``data[starts[k] : starts[k] + spans_s[k]]`` for every k, in
    order, as one byte stream; returns the output offsets (int64 [n+1]).

    Gathers in bounded blocks through one source-index buffer built with
    ``np.repeat``; ``data`` may be any contiguous array-like, including a
    memmap (the capped makedb spill).
    """
    n = len(spans_s)
    out_off = np.zeros(n + 1, np.int64)
    np.cumsum(spans_s, out=out_off[1:])
    total = int(out_off[-1])
    bounds = np.searchsorted(
        out_off,
        np.arange(1, total // block_chars + 2) * block_chars,
        side="left",
    )
    i = 0
    for j in bounds:
        j = min(int(j), n)
        if j <= i:
            continue
        sp = spans_s[i:j]
        tot = int(out_off[j] - out_off[i])
        if tot:
            # Source index of every output byte: each record's start,
            # repeated over its span, plus the offset inside the span.
            rel = out_off[i:j] - out_off[i]
            src = np.repeat(starts[i:j] - rel, sp) + np.arange(tot, dtype=np.int64)
            f.write(np.take(data, src).tobytes())
        i = j
    return out_off


def write_db_permuted(
    prefix, chars, offsets, lengths, headers_blob, header_offsets, order
) -> None:
    """Write the 6-file format given a precomputed permutation, reading
    sequence/header bytes through any array-like (incl. the capped
    makedb's spill memmaps)."""
    n = len(lengths)
    if n > MAX_SEQUENCES_IN_DB:
        raise ValueError(f"too many sequences: {n} > {MAX_SEQUENCES_IN_DB}")
    lengths = np.asarray(lengths, dtype=np.int64)
    offsets = np.asarray(offsets, dtype=np.int64)
    header_offsets = np.asarray(header_offsets, dtype=np.int64)

    files = _chunk_files(prefix)
    sorted_lengths = lengths[order]
    with open(prefix + "metadata", "wb"):
        pass  # empty global info marker, like the reference
    with open(files["metadata"], "wb") as f:
        bounds = np.asarray(LENGTH_PARTITION_BOUNDARIES, dtype=np.int32)
        np.int32(len(bounds)).tofile(f)
        bounds.tofile(f)
        partition_histogram(sorted_lengths).tofile(f)

    with open(files["lengths"], "wb") as fl:
        sorted_lengths.astype(np.int32).tofile(fl)

    chars = chars if isinstance(chars, np.memmap) else np.ascontiguousarray(
        chars, dtype=np.int8
    )
    spans_s = (offsets[1:] - offsets[:-1])[order]
    with open(files["chars"], "wb") as fc:
        out_off = _write_permuted_stream(fc, chars, offsets[:-1][order], spans_s)
    with open(files["offsets"], "wb") as fo:
        out_off.astype(np.uint64).tofile(fo)

    hspans_s = (header_offsets[1:] - header_offsets[:-1])[order]
    with open(files["headers"], "wb") as fh:
        out_hoff = _write_permuted_stream(
            fh, headers_blob, header_offsets[:-1][order], hspans_s
        )
    with open(files["headeroffsets"], "wb") as fho:
        out_hoff.astype(np.uint64).tofile(fho)


def write_db_from_arrays(
    prefix: str,
    chars: np.ndarray,
    offsets: np.ndarray,
    lengths: np.ndarray,
    headers: list[bytes],
) -> None:
    """Write the 6-file format, sorting sequences by length ascending
    (stable, like the reference)."""
    n = len(lengths)
    order = np.argsort(np.asarray(lengths), kind="stable")
    hlens = np.fromiter((len(h) for h in headers), np.int64, count=n)
    hoffs = np.zeros(n + 1, np.int64)
    np.cumsum(hlens, out=hoffs[1:])
    blob = np.frombuffer(b"".join(headers), np.uint8)
    write_db_permuted(prefix, chars, offsets, lengths, blob, hoffs, order)


def _encoded_records(records, progress_every: int = 0):
    """Yield (encoded chars padded to x4, length, header bytes) per record,
    with the reference's limits checked (pad with ' ', which encodes to
    UNKNOWN, like src/makedb.cpp:107-133)."""
    count = 0
    for rec in records:
        seq = rec.sequence
        if len(seq) > MAX_SEQUENCE_LENGTH:
            raise ValueError(
                f"sequence of length {len(seq)} exceeds maximum {MAX_SEQUENCE_LENGTH}"
            )
        if count >= MAX_SEQUENCES_IN_DB:
            raise ValueError(f"more than {MAX_SEQUENCES_IN_DB} sequences")
        padded = seq + " " * (pad_length(len(seq)) - len(seq))
        count += 1
        if progress_every and count % progress_every == 0:
            print(f"  parsed {count} sequences ...", flush=True)
        yield encode(padded), len(seq), rec.header.encode("latin-1", errors="replace")


def _check_limits(count: int, lengths) -> None:
    """The reference's limits on a parsed batch: ``count`` sequences so far
    (this batch's included) and its lengths."""
    if count > MAX_SEQUENCES_IN_DB:
        raise ValueError(f"more than {MAX_SEQUENCES_IN_DB} sequences")
    longest = int(np.max(lengths, initial=0))
    if longest > MAX_SEQUENCE_LENGTH:
        raise ValueError(f"sequence of length {longest} exceeds maximum {MAX_SEQUENCE_LENGTH}")


def _encoded_batches(input_path: str, progress_every: int = 0, chunk_chars: int = 64 << 20):
    """Yield (chars int8 padded to x4, offsets, lengths, headers list of
    bytes) batches of complete records: from the native parser where its
    library loads (``native.stream_fasta_native``), else from the Python
    reader (as the JAX package's ``_encoded_batches``)."""
    from ..native import get_lib, stream_fasta_native

    if get_lib() is not None:
        count = 0
        for batch in stream_fasta_native(input_path, chunk_chars):
            count += len(batch[2])
            _check_limits(count, batch[2])
            if progress_every and count % progress_every < len(batch[2]):
                print(f"  parsed {count} sequences ...", flush=True)
            yield batch
        return
    bufs, offsets, lengths, headers, nbytes = [], [0], [], [], 0
    for chars, length, header in _encoded_records(read_sequences(input_path), progress_every):
        bufs.append(chars)
        nbytes += len(chars)
        offsets.append(offsets[-1] + len(chars))
        lengths.append(length)
        headers.append(header)
        if nbytes >= chunk_chars:
            yield (np.concatenate(bufs), np.asarray(offsets, np.int64),
                   np.asarray(lengths, np.int32), headers)
            bufs, offsets, lengths, headers, nbytes = [], [0], [], [], 0
    if lengths:
        yield (np.concatenate(bufs), np.asarray(offsets, np.int64),
               np.asarray(lengths, np.int32), headers)


def make_db_capped(
    input_path: str,
    prefix: str,
    mem_limit: int,
    tempdir: str | None = None,
    progress_every: int = 0,
) -> dict:
    """Memory-capped ``makedb``: spills encoded sequence/header bytes to
    temp files during the parse (batch by batch, ``_encoded_batches``),
    then writes the length-sorted output by random access into the spill
    (the reference's FileBackedUVector mechanism, src/mmapbuffer.hpp:332-500
    and src/makedb.cpp:80-103).  Only the per-sequence index stays in RAM;
    the output is byte-identical to ``make_db``."""
    tempdir = tempdir or os.path.dirname(os.path.abspath(prefix))
    del mem_limit  # the index is O(n); char data always spills in this mode

    with tempfile.NamedTemporaryFile(dir=tempdir, suffix=".chars") as tc, \
         tempfile.NamedTemporaryFile(dir=tempdir, suffix=".hdrs") as th:
        offsets = [np.zeros(1, np.int64)]
        lengths = []
        hoffsets = [np.zeros(1, np.int64)]
        for bchars, boffs, blens, bheaders in _encoded_batches(input_path, progress_every):
            tc.write(np.asarray(bchars, dtype=np.int8).tobytes())
            offsets.append(offsets[-1][-1] + np.asarray(boffs[1:], np.int64))
            lengths.append(np.asarray(blens, np.int32))
            th.write(b"".join(bheaders))
            hlens = np.fromiter((len(h) for h in bheaders), np.int64, count=len(bheaders))
            hoffsets.append(hoffsets[-1][-1] + np.cumsum(hlens))
        tc.flush()
        th.flush()

        lengths_a = np.concatenate(lengths) if lengths else np.zeros(0, np.int32)
        offsets_a = np.concatenate(offsets)
        hoff_a = np.concatenate(hoffsets)
        chars_mm = (
            np.memmap(tc.name, dtype=np.int8, mode="r")
            if offsets_a[-1] else np.zeros(0, np.int8)
        )
        hdr_mm = (
            np.memmap(th.name, dtype=np.uint8, mode="r")
            if hoff_a[-1] else np.zeros(0, np.uint8)
        )
        order = np.argsort(lengths_a, kind="stable")
        write_db_permuted(prefix, chars_mm, offsets_a, lengths_a, hdr_mm, hoff_a, order)
        return {
            "num_sequences": len(lengths_a),
            "num_chars": int(lengths_a.astype(np.int64).sum()),
            "num_padded_chars": int(offsets_a[-1]),
        }


def make_db(
    input_path: str,
    prefix: str,
    records: Iterable | None = None,
    progress_every: int = 0,
) -> dict:
    """The ``makedb`` pipeline: FASTA(.gz) -> padded, encoded, length-sorted
    DB (the reference's src/makedb.cpp:279-374).  Returns summary stats.

    Parses ``input_path`` with the native C++ parser where its library
    loads (``native.parse_fasta_native``), else with the Python reader, as
    the JAX package does; ``records`` (parsed records) skip the parse.
    Both paths write the same bytes.
    """
    if records is None:
        from ..native import parse_fasta_native

        native = parse_fasta_native(input_path, header_blob=True)
        if native is not None:
            chars, offsets, lengths, (hblob, hoffs) = native
            _check_limits(len(lengths), lengths)
            order = np.argsort(lengths, kind="stable")
            write_db_permuted(prefix, chars, offsets, lengths, hblob, hoffs, order)
            return {
                "num_sequences": int(len(lengths)),
                "num_chars": int(lengths.astype(np.int64).sum()),
                "num_padded_chars": int(len(chars)),
            }
    chars_parts: list[np.ndarray] = []
    offsets = [0]
    lengths: list[int] = []
    headers: list[bytes] = []
    it = records if records is not None else read_sequences(input_path)
    for chars, length, header in _encoded_records(it, progress_every):
        chars_parts.append(chars)
        offsets.append(offsets[-1] + len(chars))
        lengths.append(length)
        headers.append(header)

    chars = np.concatenate(chars_parts) if chars_parts else np.zeros(0, dtype=np.int8)
    write_db_from_arrays(
        prefix,
        chars,
        np.asarray(offsets, dtype=np.int64),
        np.asarray(lengths, dtype=np.int32),
        headers,
    )
    return {
        "num_sequences": len(lengths),
        "num_chars": int(np.asarray(lengths, dtype=np.int64).sum()),
        "num_padded_chars": int(offsets[-1]),
    }


def pseudo_to_dbdata(pdb) -> DBData:
    """Adapt a PseudoDB to the DBData interface (all lengths equal, so it is
    already length-sorted)."""
    header_offsets = np.zeros(pdb.num + 1, dtype=np.uint64)
    header_offsets[1:] = np.cumsum([len(h) for h in pdb.headers]).astype(np.uint64)
    headers = np.frombuffer(b"".join(pdb.headers), dtype=np.uint8)
    return DBData(
        chars=pdb.chars,
        offsets=pdb.offsets.astype(np.uint64),
        lengths=pdb.lengths,
        headers=headers,
        header_offsets=header_offsets,
    )
