"""``align`` — search queries against a database (the port's counterpart of
cudasw4_tpu/cli/align.py).

The same flag surface and byte-identical plain and TSV output as the JAX
package's align, plus ``--device`` (``cuda`` by default; ``cpu`` runs the
kernels' plain PyTorch versions).  The packed tiles are stored beside the
database (``<db>0.tpupack.npz``, the JAX package's tile store): built on
the first run, memmapped on the next.  A database whose tiles and a
streamed pass's working memory pass ``--maxGpuMem`` streams in chunks of
``--maxBatchBytes`` and ``--maxBatchSequences``.  ``--tuning FILE``
applies a gridsearch config before the engine is made (so the device's
packaged config does not apply); ``--profile DIR`` writes a
``torch.profiler`` Chrome trace of the scans into DIR; ``--warmup`` (and
``--interactive``) launch every kernel instance a single scan reaches at
start-up (``SearchEngine(warmup=True)``).

Usage: python -m cudasw4_tpu_torch.cli.align --query q.fa --db prefix [--top N] [--tsv]
"""

from __future__ import annotations

import sys

from ..db.fasta import read_sequences
from ..db.format import LoadDBError, load_db, pseudo_to_dbdata
from ..db.pseudo import make_pseudo_db
from ..engine import ScanResult, SearchEngine
from ..substitution import make_scoring_config
from ..utils.profiling import device_trace


def parse_memory_string(s: str) -> int:
    if not s:
        return 0
    mult = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30}.get(s[-1].upper())
    if mult:
        return int(s[:-1]) * mult
    return int(s)


_KERNEL_TYPES = {"Half2", "DPXs16", "DPXs32", "Float"}


def parse_args(argv: list[str]) -> dict:
    opts = {
        "help": False,
        "verbose": False,
        "warmup": False,
        "interactive": False,
        "print_length_partitions": False,
        "upload_full": False,
        "prefetch_db_file": False,
        "top": 10,
        "gop": None,
        "gex": None,
        "mat": "blosum62",
        "tsv": False,
        "of": "/dev/stdout",
        "db": None,
        "queries": [],
        "pseudodb": None,
        "max_batch_bytes": 128 << 20,
        "max_batch_sequences": 10_000_000,
        "max_temp_bytes": 4 << 30,
        "got_max_temp_bytes": False,
        "max_gpu_mem": None,
        "kernel_types": {},
        "dpx": False,
        "profile": None,
        "tuning": None,
        "device": None,
    }
    i = 0
    while i < len(argv):
        a = argv[i]

        def val():
            nonlocal i
            i += 1
            if i >= len(argv):
                raise SystemExit(f"missing value for {a}")
            return argv[i]

        if a == "--help":
            opts["help"] = True
        elif a == "--verbose":
            opts["verbose"] = True
        elif a == "--interactive":
            opts["interactive"] = True
        elif a == "--warmup":
            opts["warmup"] = True
        elif a == "--printLengthPartitions":
            opts["print_length_partitions"] = True
        elif a == "--uploadFull":
            opts["upload_full"] = True
        elif a == "--prefetchDBFile":
            opts["prefetch_db_file"] = True
        elif a == "--top":
            opts["top"] = int(val())
        elif a == "--gop":
            opts["gop"] = int(val())
        elif a == "--gex":
            opts["gex"] = int(val())
        elif a == "--mat":
            opts["mat"] = val()
        elif a == "--tsv":
            opts["tsv"] = True
        elif a == "--of":
            opts["of"] = val()
        elif a == "--db":
            opts["db"] = val()
        elif a == "--query":
            opts["queries"].append(val())
        elif a == "--pseudodb":
            num = int(val())
            length = int(val())
            opts["pseudodb"] = (num, length)
        elif a == "--maxBatchBytes":
            opts["max_batch_bytes"] = parse_memory_string(val())
        elif a == "--maxBatchSequences":
            opts["max_batch_sequences"] = int(val())
        elif a == "--maxTempBytes":
            opts["max_temp_bytes"] = parse_memory_string(val())
            opts["got_max_temp_bytes"] = True
        elif a == "--maxGpuMem":
            opts["max_gpu_mem"] = parse_memory_string(val())
        elif a in (
            "--singlePassType",
            "--manyPassType_small",
            "--manyPassType_large",
            "--overflowType",
        ):
            v = val()
            if v not in _KERNEL_TYPES:
                # The reference coerces unknown names to Half2
                # (src/options.cpp:81-86); warn so a typo is visible.
                print(
                    f"Warning: unknown kernel type '{v}' for {a}; "
                    f"falling back to Half2"
                )
                v = "Half2"
            opts["kernel_types"][a[2:]] = v
        elif a == "--dpx":
            opts["dpx"] = True
        elif a == "--profile":
            opts["profile"] = val()
        elif a == "--tuning":
            opts["tuning"] = val()
        elif a == "--device":
            opts["device"] = val()
        else:
            print(f"Unexpected arg {a}")
        i += 1
    return opts


HELP = """Usage: align [options]
   Mandatory
      --query queryfile : Fasta or Fastq. Can be gzip'ed. Repeat for multiple query files
      --db dbPrefix : The DB to query against. The same dbPrefix as used for makedb

   Scoring
      --top val : Output the val best scores. Default val = 10
      --gop val : Gap open score. Overwrites the blosum-dependent default score.
      --gex val : Gap extend score. Overwrites the blosum-dependent default score.
      --mat val : Substitution matrix: blosum45, blosum50, blosum62, blosum80 (classic 21-letter),
                  or blosum45_full .. blosum80_full (25-dim with B/J/Z/X/*, the reference's
                  CAN_USE_FULL_BLOSUM mode). Default blosum62

   Misc
      --of val : Result output file. Default: console output (/dev/stdout)
      --tsv : Print results as tab-separated values instead of plain text.
      --verbose : More console output. Shows timings.
      --printLengthPartitions : Print number of sequences per length bucket in db.
      --interactive : Loads DB, then waits for sequence input by user
      --warmup : Launch every kernel a single scan reaches at startup, not at the first query.
      --device val : cuda (default) or cpu (the kernels' plain PyTorch versions).
      --help : Print this message

   Performance and benchmarking
      --prefetchDBFile : Load DB into RAM immediately at program start.
      --uploadFull : Keep the whole DB on the device, whatever its size.
      --pseudodb num length : Use a generated DB with num equal sequences of length length.
      --maxBatchBytes val : Most tile bytes of one streamed chunk (suffix K,M,G). Default 128M.
      --maxBatchSequences val : Most subject slots of one streamed chunk. Default 10000000.
      --maxTempBytes : bound on the long-query boundary-carry temp of long-subject buckets.
      --maxGpuMem val : Device-memory budget (suffix K,M,G; default 0.7 of the card's
           memory). A DB whose packed tiles and a streamed pass's working memory exceed
           it streams: as much as the rest of the budget holds stays on the device, the
           rest crosses the link once per pass of up to 20 queries.
      --tuning file.json : Apply a gridsearch --emit-config tuning file (kernel speed ratios
           for the bucket layout chooser, CELL_MAX_L, the col kernels' NQC and LC; also via
           env CUDASW4_TPU_TORCH_TUNING).  Otherwise a packaged config for the card
           (cudasw4_tpu_torch/tuning/) applies; CUDASW4_TPU_TORCH_AUTO_TUNING=0 opts out.
      --profile dir : Write a torch.profiler Chrome trace of the scans into dir.
      --singlePassType/--manyPassType_small/--manyPassType_large/--overflowType val, --dpx :
           Kernel family selection (Half2|DPXs16|DPXs32|Float).  The single-pass type decides:
           Half2/DPXs16 (or --dpx) run int16 DP state, re-scoring the tiles whose scores
           saturate with exact int32 state; Float/DPXs32 run exact int32 state (the default,
           unless CUDASW4_TPU_TORCH_STATE16=1).
"""


def print_scan_result_plain(out, result: ScanResult, engine: SearchEngine):
    for i, (score, ref) in enumerate(zip(result.scores, result.reference_ids)):
        out.write(
            f"Result {i}. Score: {score}. "
            f"Length: {engine.get_reference_length(ref)}. "
            f"Header {engine.get_reference_header(ref)}. "
            f"referenceId {ref}\n"
        )


TSV_HEADER = (
    "Query number\tQuery length\tQuery header\tResult number\tResult score\t"
    "Reference length\tReference header\tReference ID in DB\n"
)


def print_scan_result_tsv(out, result, engine, query_id, query_len, query_header):
    for i, (score, ref) in enumerate(zip(result.scores, result.reference_ids)):
        out.write(
            f"{query_id}\t{query_len}\t{query_header}\t{i}\t{score}\t"
            f"{engine.get_reference_length(ref)}\t"
            f"{engine.get_reference_header(ref)}\t{ref}\n"
        )


# Kernel-type combination rules and error texts of the reference
# (src/cudasw4.cuh:590-604, 841-855): manyPass_small must be a 16-bit
# family, manyPass_large/overflow a 32-bit one.
_KT_RULES = (
    ("singlePassType", {"Half2", "DPXs16", "DPXs32", "Float"},
     "Invalid singlepass kernel type"),
    ("manyPassType_small", {"Half2", "DPXs16"},
     "Invalid manyPassType_small kernel type"),
    ("manyPassType_large", {"Float", "DPXs32"},
     "Invalid manyPassType_large kernel type"),
    ("overflowType", {"Float", "DPXs32"},
     "Invalid overflow kernel type"),
)


def run(argv=None) -> int:
    opts = parse_args(sys.argv[1:] if argv is None else argv)
    if opts["help"] or (not opts["queries"] and not opts["interactive"]) or (
        opts["db"] is None and opts["pseudodb"] is None
    ):
        if not opts["help"]:
            if not opts["queries"] and not opts["interactive"]:
                print("Query is missing")
            if opts["db"] is None and opts["pseudodb"] is None:
                print("DB prefix is missing")
        print(HELP)
        return 0

    for slot, allowed, msg in _KT_RULES:
        v = opts["kernel_types"].get(slot)
        if v is not None and v not in allowed:
            print(msg)
            return 1
    if opts["tuning"]:
        # gridsearch --emit-config: measured speed ratios and geometry for
        # the layout chooser and the col kernels; an explicit config wins
        # over the device's packaged one.
        from ..db import packing

        packing.apply_tuning(opts["tuning"])

    scoring = make_scoring_config(opts["mat"], gop=opts["gop"], gex=opts["gex"])
    engine = SearchEngine(
        scoring=scoring,
        num_top=opts["top"],
        device=opts["device"],
        # --maxGpuMem caps device residency (a larger DB streams);
        # --uploadFull forces residency like the reference flag.
        max_device_bytes=(1 << 62) if opts["upload_full"] else opts["max_gpu_mem"],
        stream_chunk_bytes=opts["max_batch_bytes"],
        # --maxBatchSequences caps the subject slots of a streamed chunk,
        # the second axis of the reference's copy plan (options.cpp:121).
        max_batch_sequences=opts["max_batch_sequences"],
        # --maxTempBytes bounds the long-query carry temp (in+out states
        # live together, so half the cap goes to each).
        col_temp_bytes=(
            max(1 << 20, opts["max_temp_bytes"] // 2)
            if opts["got_max_temp_bytes"] else None
        ),
        verbose=opts["verbose"],
        warmup=opts["warmup"] or opts["interactive"],
    )
    # Kernel-type selection (the reference's --dpx preset and single-pass
    # type): the 16-bit families run int16 state with the exact overflow
    # re-score, the 32-bit families exact int32 state.
    sp = opts["kernel_types"].get("singlePassType")
    if opts["dpx"] or sp in ("Half2", "DPXs16"):
        engine.state16 = True
    elif sp in ("Float", "DPXs32"):
        engine.state16 = False
    if opts["verbose"]:
        print("Selected options:")
        print(f"blosum: {opts['mat'].upper()}")
        print(f"gop: {scoring.gop}")
        print(f"gex: {scoring.gex}")
        print(f"numTopOutputs: {opts['top']}")
        print(f"Output mode: {'TSV' if opts['tsv'] else 'Plain'}")
        print(f"Output file: {opts['of']}")

    if opts["pseudodb"] is not None:
        num, length = opts["pseudodb"]
        if opts["verbose"]:
            print("Generating pseudo db")
        db = pseudo_to_dbdata(make_pseudo_db(num, length))
    else:
        if opts["verbose"]:
            print("Reading Database:")
        try:
            db = load_db(opts["db"], mmap=not opts["prefetch_db_file"])
        except LoadDBError as ex:
            print(f"Failed to load db: {ex}")
            return 1
    # The tile store beside the db files: packed once, memmapped after
    # (none for a pseudo DB).
    cache = opts["db"] + "0.tpupack.npz" if opts["db"] else None
    engine.set_database(db, pack_cache=cache)

    if opts["verbose"]:
        engine.print_db_info()
        if opts["print_length_partitions"]:
            engine.print_db_length_partitions()

    out = sys.stdout if opts["of"] == "/dev/stdout" else open(opts["of"], "w")
    try:
        if opts["tsv"]:
            out.write(TSV_HEADER)
        if not opts["interactive"]:
            query_num = 0
            engine.total_timer_start()
            records = []

            def sequences():
                for queryfile in opts["queries"]:
                    print(f"Processing query file {queryfile}")
                    for rec in read_sequences(queryfile):
                        records.append(rec)
                        yield rec.sequence

            # --profile: a torch.profiler trace of the scans (a no-op without).
            with device_trace(opts["profile"]):
                for result in engine.scan_many(sequences()):
                    rec = records[query_num]
                    print(f"Processing query {query_num} ... ", end="", flush=True)
                    if opts["verbose"]:
                        print(
                            f"Done. Scan time: {result.stats.seconds:.6g} s, "
                            f"{result.stats.gcups:.6g} GCUPS"
                        )
                    else:
                        print("Done.")
                    if opts["top"] > 0:
                        if not opts["tsv"]:
                            out.write(
                                f"Query {query_num}, header{rec.header}"
                                f", length {len(rec.sequence)}"
                                f", num overflows {result.stats.num_overflows}\n"
                            )
                            print_scan_result_plain(out, result, engine)
                        else:
                            print_scan_result_tsv(
                                out, result, engine, query_num,
                                len(rec.sequence), rec.header,
                            )
                        out.flush()
                    query_num += 1
            total = engine.total_timer_stop()
            if opts["verbose"]:
                print(f"Total time: {total.seconds:.6g} s, {total.gcups:.6g} GCUPS")
        else:
            _interactive_loop(engine, opts, out)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def _interactive_loop(engine, opts, out):
    print("Interactive mode ready")
    print("Use 's inputsequence' to query inputsequence against the database. Press ENTER twice to begin.")
    print("Use 'f inputfile' to query all sequences in inputfile")
    print("Use 'exit' to terminate")
    print("Waiting for command...")
    for line in sys.stdin:
        tokens = line.split()
        if not tokens:
            continue
        cmd = tokens[0]
        if cmd == "exit":
            break
        elif cmd == "s":
            if len(tokens) > 1:
                seq = tokens[1]
                for extra in sys.stdin:
                    extra = extra.strip()
                    if not extra:
                        break
                    seq += extra
                print(f"sequence: {seq}")
                print("Processing query 0 ... ", end="", flush=True)
                result = engine.scan(seq)
                print(
                    f"Done. Scan time: {result.stats.seconds:.6g} s, "
                    f"{result.stats.gcups:.6g} GCUPS"
                    if opts["verbose"] else "Done."
                )
                if not opts["tsv"]:
                    print_scan_result_plain(out, result, engine)
                else:
                    print_scan_result_tsv(out, result, engine, -1, len(seq), "-")
                out.flush()
            else:
                print("Missing argument for command 's'")
        elif cmd == "f":
            if len(tokens) > 1:
                try:
                    qn = 0
                    for rec in read_sequences(tokens[1]):
                        print(f"Processing query {qn} ... ", end="", flush=True)
                        result = engine.scan(rec.sequence)
                        print("Done.")
                        if not opts["tsv"]:
                            out.write(
                                f"Query {qn}, header{rec.header}"
                                f", length {len(rec.sequence)}"
                                f", num overflows {result.stats.num_overflows}\n"
                            )
                            print_scan_result_plain(out, result, engine)
                        else:
                            print_scan_result_tsv(
                                out, result, engine, -1, len(rec.sequence), "-"
                            )
                        out.flush()
                        qn += 1
                except (OSError, ValueError) as ex:
                    print(f"Error: {ex}")
            else:
                print("Missing argument for command 'f'")
        else:
            print(f"Unrecognized command: {cmd}")
        print("Waiting for command...")


def main():
    raise SystemExit(run())


if __name__ == "__main__":
    main()
