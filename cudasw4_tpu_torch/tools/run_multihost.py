"""Search a database sharded over the devices of several processes (the
port's counterpart of benchmarks/run_multihost.py).

Every process loads the same database and query file, joins the process
group at ``--coordinator``, contributes its shards to one global mesh
(parallel/multihost.py), and scans the queries in the same order; each
process scores its own shards, the candidates of every shard are merged on
every process, and the primary (rank 0) prints the hits to standard
output.  Every other process writes the same lines to its standard error,
its log, which shows that each holds the merged hits.  Without
``--num-processes`` it runs alone on a mesh of its own devices.
``--coordinator`` is "host:port" (rank 0 listens there) or, for processes
that share a file system, "file:///path" (a file that does not exist yet:
no port to choose).

One process per card, e.g. on two hosts of four cards (one command per
process, ``ID`` = 0..7, each with its own card):

    CUDA_VISIBLE_DEVICES=$LOCAL python -m cudasw4_tpu_torch.tools.run_multihost \\
        --db path/db --query q.fa --coordinator host0:29500 \\
        --num-processes 8 --process-id $ID

Two processes on one card share it as two shards; NCCL refuses two ranks
on one card, so they gather over gloo (``--backend gloo``).  ``--device
cpu`` runs the plain PyTorch versions (gloo), ``--shards N`` gives each
process N shards (default: its visible cards, or 1 on the CPU).
``--maxGpuMem`` is the budget of one shard (a larger database streams),
``--maxBatchBytes`` the streamed chunk cap, ``--packCache`` the tile
store's path (per process for per-host stores on local disks, or shared).
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv):
    from ..cli.align import parse_memory_string

    ap = argparse.ArgumentParser(prog="run_multihost")
    ap.add_argument("--db", required=True)
    ap.add_argument("--query", required=True)
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--coordinator")
    ap.add_argument("--num-processes", type=int)
    ap.add_argument("--process-id", type=int)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"))
    ap.add_argument("--shards", type=int)
    ap.add_argument("--maxGpuMem", type=parse_memory_string)
    ap.add_argument("--maxBatchBytes", type=parse_memory_string)
    ap.add_argument("--packCache")
    return ap.parse_args(argv)


def local_devices(device: str, shards: int | None) -> list:
    """This process's shards: ``shards`` of them over its visible cards in
    turn (default one a card), or on the CPU."""
    import torch

    if device == "cpu":
        return ["cpu"] * (shards or 1)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu")
    n = torch.cuda.device_count()
    return [f"cuda:{i % n}" for i in range(shards or n)]


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    from ..db.fasta import read_sequences
    from ..db.format import load_db
    from ..engine import SearchEngine
    from ..engine_streaming import STREAM_CHUNK_BYTES
    from ..parallel.multihost import global_mesh, initialize, is_primary, shutdown

    backend = args.backend
    if backend is None and (args.num_processes or 1) > 1:
        backend = "gloo" if args.device == "cpu" else "nccl"
    initialize(coordinator=args.coordinator, num_processes=args.num_processes,
               process_id=args.process_id, backend=backend)
    try:
        engine = SearchEngine(num_top=args.top, mesh=global_mesh(local_devices(args.device,
                                                                               args.shards)),
                              max_device_bytes=args.maxGpuMem,
                              stream_chunk_bytes=args.maxBatchBytes or STREAM_CHUNK_BYTES)
        engine.set_database(load_db(args.db), pack_cache=args.packCache)
        records = list(read_sequences(args.query))
        engine.total_timer_start()
        out = sys.stdout if is_primary() else sys.stderr
        for rec, res in zip(records, engine.scan_many(r.sequence for r in records)):
            print(f"# {rec.header}", file=out)
            for i, (score, ref) in enumerate(zip(res.scores, res.reference_ids)):
                print(f"{i}\t{score}\t{engine.get_reference_length(ref)}\t"
                      f"{engine.get_reference_header(ref)}\t{ref}", file=out)
        total = engine.total_timer_stop()
        print(f"Total {total.seconds:.3f}s {total.gcups:.2f} GCUPS", file=out, flush=True)
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
