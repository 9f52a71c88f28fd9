"""``makedb`` — build a database from FASTA/FASTQ (the port's counterpart of
cudasw4_tpu/cli/makedb.py).

Argument surface of the reference makedb (src/makedb.cpp:279-374): input
file, output prefix, optional --mem limit and --tempdir.  Under a --mem cap
makedb spills to temp files (db/format.py make_db_capped); the output
is byte-identical either way, and byte-identical to the JAX package's.
--prepack/--prepackStream (the JAX package's tile store) wait for the
disk-store slice of the port.

Usage: python -m cudasw4_tpu_torch.cli.makedb db.fasta prefix [--mem 4G] [--tempdir DIR]
"""

from __future__ import annotations

import sys
import time

from ..db.format import make_db, make_db_capped
from .align import parse_memory_string

USAGE = """Usage:
  makedb <FASTA/FASTQ filename> pathtodb/dbname [options]
Input file may be gzip'ed. pathtodb must exist.
Options:
    --mem val : Memory limit. Can use suffix K,M,G.
    --tempdir val : Temp directory for temporary files. Must exist.
    --prepack, --prepackStream val : build the tile store now (a later
        slice of this port).
"""


def run(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(USAGE)
        return 0
    input_path, prefix = argv[0], argv[1]
    mem = None
    tempdir = None
    i = 2
    while i < len(argv):
        takes_value = argv[i] in ("--mem", "--tempdir", "--prepackStream")
        if takes_value and i + 1 >= len(argv):
            print(f"Missing value for {argv[i]}")
            print(USAGE)
            return 1
        if argv[i] == "--mem":
            i += 1
            mem = parse_memory_string(argv[i])
        elif argv[i] == "--tempdir":
            i += 1
            tempdir = argv[i]
        elif argv[i] in ("--prepack", "--prepackStream"):
            raise NotImplementedError(
                f"{argv[i]} (the tile store) waits for the disk-store slice of the port"
            )
        else:
            print(f"Unexpected arg {argv[i]}")
        i += 1

    print("Parsing file")
    t0 = time.perf_counter()
    if mem is not None:
        stats = make_db_capped(
            input_path, prefix, mem, tempdir=tempdir, progress_every=1_000_000
        )
    else:
        stats = make_db(input_path, prefix, progress_every=1_000_000)
    dt = time.perf_counter() - t0
    print(f"Number of input sequences:  {stats['num_sequences']}")
    print(f"Number of input characters: {stats['num_chars']}")
    print(f"TIMING: db creation: {dt:.6g} s")
    return 0


def main():
    raise SystemExit(run())


if __name__ == "__main__":
    main()
