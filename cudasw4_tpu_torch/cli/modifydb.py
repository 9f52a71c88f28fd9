"""``modifydb`` — in-place database migrations (the port's counterpart of
cudasw4_tpu/cli/modifydb.py, with its operations, output and exit codes).

    python -m cudasw4_tpu_torch.cli.modifydb operation dbprefix

* ``convertcharstonumber1`` — rewrite a chars file holding raw ASCII amino
  acids into encoded 0..20 codes, in place (the reference's modifydb).
* ``lengthsToI32`` / ``lengthsToI64`` — write the lengths file with another
  integer width to ``<prefix>0lengths_i32`` / ``_i64``.
* ``verify`` — check the files' consistency (offsets strictly increasing,
  lengths sorted, padded extents, the chars file size, the code range,
  the metadata histogram); exit code 1 with an ``INVALID:`` line for each
  fault, else 0.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..constants import ENCODE_TABLE
from ..db.format import load_db, partition_histogram

USAGE = ("Usage:\n  modifydb operation dbprefix\n"
         "Operations: convertcharstonumber1, lengthsToI32, lengthsToI64, verify\n")


def _verify(prefix: str) -> list[str]:
    """The faults that ``verify`` reports for the database at ``prefix``."""
    db = load_db(prefix)
    errors = []
    offs = np.asarray(db.offsets, dtype=np.int64)
    lens = np.asarray(db.lengths, dtype=np.int64)
    if not np.all(np.diff(offs) > 0):
        errors.append("offsets not strictly increasing")
    if not np.all(lens[1:] >= lens[:-1]):
        errors.append("lengths not sorted ascending")
    if not np.all(np.diff(offs) >= lens):
        errors.append("padded extents smaller than lengths")
    if int(offs[-1]) != db.num_padded_chars:
        errors.append("final offset != chars file size")
    if db.num_padded_chars and (np.asarray(db.chars).min() < 0 or np.asarray(db.chars).max() > 20):
        errors.append("chars outside encoded range 0..20 (raw ASCII db? "
                      "run convertcharstonumber1)")
    try:
        with open(prefix + "0metadata", "rb") as f:
            raw = f.read()
        n = np.frombuffer(raw[:4], dtype=np.int32)[0]
        counts = np.frombuffer(raw[4 + 4 * n:], dtype=np.uint64)
        if counts.sum() != db.num_sequences:
            errors.append("metadata histogram total != numSequences")
        expect = partition_histogram(lens)
        if len(counts) == len(expect) and not np.array_equal(counts, expect):
            errors.append("metadata histogram differs from recomputed")
    except OSError:
        errors.append("missing chunk metadata file")
    if not errors:
        print(f"OK: {db.num_sequences} sequences, {db.num_chars} residues, "
              f"max length {int(lens.max(initial=0))}")
    return errors


def run(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(USAGE)
        return 0
    operation, prefix = argv[0], argv[1]
    if operation == "convertcharstonumber1":
        t0 = time.perf_counter()
        data = np.memmap(prefix + "0chars", dtype=np.uint8, mode="r+")
        chunk = 64 << 20
        for i in range(0, len(data), chunk):
            data[i:i + chunk] = ENCODE_TABLE.view(np.uint8)[data[i:i + chunk]]
        data.flush()
        print(f"# elapsed time (convertcharstonumber1): {time.perf_counter() - t0:.6g}s")
    elif operation in ("lengthsToI32", "lengthsToI64"):
        lengths = np.asarray(load_db(prefix).lengths, dtype=np.int64)
        suffix = "_i32" if operation == "lengthsToI32" else "_i64"
        if operation == "lengthsToI32" and lengths.max(initial=0) >= 2**31 - 1:
            raise ValueError("a length does not fit int32")
        lengths.astype(np.int32 if suffix == "_i32" else np.int64).tofile(
            prefix + "0lengths" + suffix)
        print(f"wrote {prefix}0lengths{suffix}")
    elif operation == "verify":
        errors = _verify(prefix)
        for e in errors:
            print(f"INVALID: {e}")
        return 1 if errors else 0
    else:
        print(f"Unknown operation {operation}")
        print(USAGE)
        return 1
    return 0


def main():
    raise SystemExit(run())


if __name__ == "__main__":
    main()
