"""``makedb`` — build a database from FASTA/FASTQ (the port's counterpart of
cudasw4_tpu/cli/makedb.py).

Argument surface of the reference makedb (src/makedb.cpp:279-374): input
file, output prefix, optional --mem limit and --tempdir.  Under a --mem cap
makedb spills to temp files (db/format.py make_db_capped); the output
is byte-identical either way, and byte-identical to the JAX package's.
--prepack also builds the tile store that align reads (<prefix>0.tpupack.npz,
byte for byte the JAX package's), and --prepackStream <budget> its
transfer-pack sidecar in the same pass when the database streams under
the budget (its tiles and a streamed pass's working memory at the default
chunk size exceed it), so the first align run loads instead of packing.

Usage: python -m cudasw4_tpu_torch.cli.makedb db.fasta prefix [--mem 4G] [--tempdir DIR]
       [--prepack] [--prepackStream 40G]
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
    --prepack : Also build the tile store now (one slab of RAM),
        so the first align run loads instead of packing.
    --prepackStream val : With --prepack, the device-memory budget (suffix
        K,M,G).  If the DB streams under it, the streaming transfer-pack
        sidecar is built in the same pass.
"""


def run(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(USAGE)
        return 0
    input_path, prefix = argv[0], argv[1]
    mem = None
    tempdir = None
    prepack = False
    prepack_budget = None
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
        elif argv[i] == "--prepack":
            prepack = True
        elif argv[i] == "--prepackStream":
            i += 1
            prepack = True
            prepack_budget = parse_memory_string(argv[i])
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
    if prepack:
        _prepack(prefix, prepack_budget)
    return 0


def _prepack(prefix: str, budget: int | None) -> None:
    """Build the tile store align derives from the prefix, and its transfer
    sidecar when the database streams under ``budget`` (its tiles and a
    streamed pass's working memory at the default chunk caps exceed it)."""
    import os

    import numpy as np

    from ..constants import UNKNOWN
    from ..db.format import load_db
    from ..db.packing import (
        _packed_layout, pack_db_to_store, planned_shapes, stream_manifest, stream_sidecar_fresh,
    )
    from ..engine_streaming import streams
    from ..ops.pack5 import STREAM_PACK_ENV, choose_codec

    t0 = time.perf_counter()
    db = load_db(prefix)
    store_path = prefix + "0.tpupack.npz"
    stream_codec = None
    if budget is not None and streams(planned_shapes(np.asarray(db.lengths, np.int64)), budget):
        stream_codec = choose_codec(os.environ.get(STREAM_PACK_ENV, "1"), int(UNKNOWN))
    store = pack_db_to_store(db, store_path, pad_code=UNKNOWN, stream_codec=stream_codec)
    dt = time.perf_counter() - t0
    wrote_sidecar = stream_codec is not None and stream_sidecar_fresh(
        store_path,
        stream_manifest(stream_codec, int(UNKNOWN), store.num_sequences,
                        store.total_real_chars, _packed_layout(store)),
    )
    print(f"TIMING: tile store{' + transfer sidecar' if wrote_sidecar else ''}: {dt:.6g} s")
    if stream_codec is not None and not wrote_sidecar:
        print("NOTE: transfer sidecar was not written (directory not writable?); "
              "the first streaming align will build it")


def main():
    raise SystemExit(run())


if __name__ == "__main__":
    main()
