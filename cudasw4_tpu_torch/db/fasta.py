"""Streaming FASTA/FASTQ reader, plain or gzip (the port's own copy of
cudasw4_tpu/db/fasta.py).

Behavioural equivalent of the reference's kseqpp reader
(the reference's src/kseqpp/kseqpp.hpp:39-154):

* header = the full line after '>'/'@' (ID and description, '\r' stripped)
* sequences may span multiple lines; empty lines are skipped
* FASTQ quality lines are parsed and discarded (the aligner ignores quality)
* gzip is auto-detected from the 2-byte magic, not the file extension

A native C++ fast path can replace this hot loop later; this implementation
is already streaming (constant memory) and handles multi-GB inputs.
"""

from __future__ import annotations

import gzip
import io
from dataclasses import dataclass
from typing import Iterator


@dataclass
class SequenceRecord:
    header: str
    sequence: str


def _open_maybe_gzip(path: str) -> io.BufferedReader:
    f = open(path, "rb")
    magic = f.peek(2)[:2]
    if magic == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=f))  # type: ignore[arg-type]
    return f


def read_sequences(path: str) -> Iterator[SequenceRecord]:
    """Yield (header, sequence) records from a FASTA/FASTQ(.gz) file."""
    with _open_maybe_gzip(path) as f:
        header: str | None = None
        seq_parts: list[str] = []
        fastq_mode = False
        line_iter = iter(f)
        for raw in line_iter:
            line = raw.rstrip(b"\r\n")
            if not line:
                continue
            lead = line[:1]
            if lead == b">" or lead == b"@":
                if header is not None:
                    yield SequenceRecord(header, "".join(seq_parts))
                header = line[1:].decode("latin-1")
                seq_parts = []
                fastq_mode = lead == b"@"
            elif lead == b"+" and fastq_mode:
                # FASTQ separator: consume quality bytes equal to seq length
                need = sum(len(p) for p in seq_parts)
                got = 0
                while got < need:
                    qraw = next(line_iter, None)
                    if qraw is None:
                        raise ValueError(f"{path}: truncated FASTQ quality for '{header}'")
                    got += len(qraw.rstrip(b"\r\n"))
                if header is not None:
                    yield SequenceRecord(header, "".join(seq_parts))
                header = None
                seq_parts = []
                fastq_mode = False
            else:
                if header is None:
                    raise ValueError(f"{path}: sequence data before first header")
                seq_parts.append(line.decode("latin-1"))
        if header is not None:
            yield SequenceRecord(header, "".join(seq_parts))


def write_fasta(path: str, records: list[tuple[str, str]]) -> None:
    """Write records as FASTA (test/fixture helper)."""
    with open(path, "w") as f:
        for header, seq in records:
            f.write(f">{header}\n{seq}\n")
