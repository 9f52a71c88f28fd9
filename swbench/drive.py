"""Set-up, warm-up and the measured window of one cell, over the engine.

The traffic mix's ``entry`` names the engine's entry that the window
drives:

- ``scan_many``: a query list through ``SearchEngine.scan_many``; a pass
  ends when its last result is on the host;
- ``scan``: one query at a time through ``SearchEngine.scan``; a query's
  time runs from the call to its top hits on the host.

Its ``arrivals`` say when the window sends:

- ``closed`` (the default): one client, passes back to back, or rounds of
  the whole query list, each round in an order drawn from the seed, one
  query at a time; the window ends with the first pass or round that ends
  after ``seconds``, so it holds whole passes or rounds only, and every
  seed the same work;
- ``poisson``: round(rate x seconds) queries, round after round in seeded
  orders, due at gaps that are the exponential distribution's quantiles
  of mean 1 / rate in an order drawn from the seed (every seed the same
  gaps); each is served when it is due and the engine is free, through
  ``scan`` one at a time or through ``scan_many`` all that are due
  together; a query's time runs from its due time to its top hits on the
  host, and the window ends with the last answer.

Warm-up runs what the window runs before it, on the same shapes: one pass
of the list, or the engine's own warm-up and a scan of the shortest and
the longest query.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class Window:
    """What the window did, on the host's clock."""

    seconds: float = 0.0
    sent: int = 0
    units: int = 0  # calls of the entry: passes, or single queries
    residues: int = 0  # query residues of every answered query
    answers: list = field(default_factory=list)  # (query's entry id, scores, ids)
    latencies: list = field(default_factory=list)  # seconds of each query
    host_copy_ms: list = field(default_factory=list)  # streamed passes, traced runs only


def engine_for(config: dict, devices: list) -> object:
    """The engine of a configuration on ``devices``: its matrix and gaps,
    resident on the first, streamed under the configuration's budget and
    chunk, or sharded over all of them (``placement``).  The state mode is
    the environment's (``run.STATE_ENV``), read when the engine is made."""
    from cudasw4_tpu_torch.engine import SearchEngine
    from cudasw4_tpu_torch.parallel import sharding
    from cudasw4_tpu_torch.substitution import make_scoring_config

    kw = {"num_top": int(config["num_top"]),
          "scoring": make_scoring_config(config["matrix"], gop=-int(config["gap_open"]),
                                         gex=-int(config["gap_extend"]))}
    placement = config["placement"]
    if placement == "mesh":
        kw["mesh"] = sharding.make_mesh(devices)
    else:
        kw["device"] = devices[0]
    if placement == "streamed":
        kw["max_device_bytes"] = int(config["max_device_bytes"])
        kw["stream_chunk_bytes"] = int(config["stream_chunk_bytes"])
    return SearchEngine(**kw)


def load(engine, db) -> None:
    """Pack the database and place it: resident, streamed or sharded."""
    from cudasw4_tpu_torch.db.format import DBData

    engine.set_database(DBData(
        chars=db.chars, offsets=db.offsets, lengths=db.lengths,
        headers=np.zeros(0, np.uint8), header_offsets=np.zeros(len(db.lengths) + 1, np.uint64)))


def warm_up(engine, traffic: dict, db, queries) -> None:
    """Run the window's shapes once (see the module docstring)."""
    codes = [db.sequence(i) for i in queries.round(0)]
    if traffic["entry"] == "scan_many":
        list(engine.scan_many(codes))
    else:
        engine.warmup()
        for q in (min(codes, key=len), max(codes, key=len)):
            engine.scan(q)


def sync(devices) -> None:
    for d in devices:
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)


def _gaps(rate: float, n: int, seed: int) -> np.ndarray:
    """n gaps between arrivals: the quantiles (k + 0.5) / n of the
    exponential distribution of mean 1 / rate, in an order drawn from seed."""
    q = (np.arange(n) + 0.5) / n
    return np.random.default_rng(seed).permutation(-np.log1p(-q) / rate)


def run_window(engine, traffic: dict, db, queries, seconds: float, seed: int,
               traced: bool = False) -> Window:
    """Drive the traffic for ``seconds`` (see the module docstring); with
    ``traced``, each query or pass is a profiler range, and a streamed
    engine's copy log is read after each call."""
    w = Window()
    rng = np.random.default_rng(seed)
    span = torch.profiler.record_function if traced else (lambda _name: contextlib.nullcontext())
    streamed = traced and getattr(engine, "streaming", False)
    many = traffic["entry"] == "scan_many"

    def serve(ids, due=None):
        """One call for the entries ``ids``; ``due``: their due times on the
        window's clock (closed arrivals: the call's start)."""
        codes = [db.sequence(i) for i in ids]
        a = time.perf_counter()
        with span("swbench:pass" if many else "swbench:query"):
            results = list(engine.scan_many(codes)) if many else [engine.scan(codes[0])]
        b = time.perf_counter()
        if not many or due is not None:
            starts = [a - t0] * len(ids) if due is None else due
            w.latencies += [b - t0 - s for s in starts]
        if streamed:
            w.host_copy_ms.append(engine.stream_copy_stats()["host_copy_ms"])
        for i, r in zip(ids, results):
            w.answers.append((i, r.scores, r.reference_ids))
            w.residues += len(db.sequence(i))
        w.sent += len(ids)
        w.units += 1

    arrivals = traffic.get("arrivals", {"kind": "closed"})
    t0 = time.perf_counter()
    if arrivals["kind"] == "closed":
        r = 0
        while True:
            ids = queries.round(r)
            if many:
                serve(ids)
            else:
                for k in rng.permutation(len(ids)).tolist():
                    serve([ids[k]])
            r += 1
            if time.perf_counter() - t0 >= seconds:
                break
    else:
        rate = float(arrivals["rate_per_s"])
        n = max(1, round(rate * seconds))
        due = np.concatenate([[0.0], np.cumsum(_gaps(rate, n, seed))[:-1]])
        order, r = [], 0
        while len(order) < n:
            ids = queries.round(r)
            order += [ids[k] for k in rng.permutation(len(ids)).tolist()]
            r += 1
        i = 0
        while i < n:
            now = time.perf_counter() - t0
            if due[i] > now:
                time.sleep(due[i] - now)
                now = time.perf_counter() - t0
            j = i + 1 if not many else max(i + 1, int(np.searchsorted(due, now, "right")))
            serve(order[i:j], due[i:j].tolist())
            i = j
    w.seconds = time.perf_counter() - t0
    return w
