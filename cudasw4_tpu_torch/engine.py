"""Search engine: a database resident on one device, per-query scans, top-N,
stats (the counterpart of the resident single-device path of
cudasw4_tpu/engine.py).

Scan flow: encode the query -> score every bucket on its kernel (cell,
row or col; col buckets chunk queries longer than NQC with the H/F carry)
-> concatenate the scores in slot order (slot order is ascending reference
id) -> mask padding slots -> top N by descending score, then ascending id.
GCUPS = query length x sum of real DB lengths / 1e9 / seconds, as the
reference's makeBenchmarkStats (src/cudasw4.cuh:2264-2271).

The engine runs on the card unless the caller asks for the CPU
(``device="cpu"``), where every wrapper takes its kernel's plain version.
Paths of the JAX engine that later slices of the port bring raise
NotImplementedError naming their slice.
"""

from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from .constants import decode, encode
from .db.format import DBData
from .db.packing import PackedDB, pack_db
from .ops import bucket_kind, cuda_lib, score_bucket, sw_cell, sw_col
from .ops.sw_row import prepare_query
from .substitution import ScoringConfig, make_scoring_config

#: Environment switch of the top-N oracle check: "1" re-scores each scan's
#: top hits on the scalar CPU oracle and raises on a mismatch.
DEBUG_CHECK_ENV = "CUDASW4_TPU_TORCH_DEBUG_CHECK"


@dataclass
class BenchmarkStats:
    seconds: float = 0.0
    gcups: float = 0.0
    num_overflows: int = 0  # int16-state overflows; always 0 (exact int32)


@dataclass
class ScanResult:
    scores: list[int] = field(default_factory=list)
    reference_ids: list[int] = field(default_factory=list)
    stats: BenchmarkStats = field(default_factory=BenchmarkStats)


def resolve_device(device=None) -> torch.device:
    """The engine's device: CUDA unless the caller names another."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "the plain PyTorch versions on the CPU"
        )
    return dev


class SearchEngine:
    """One-device, resident-database search engine."""

    def __init__(
        self,
        scoring: ScoringConfig | None = None,
        num_top: int = 10,
        device=None,
        max_device_bytes: int | None = None,
        col_temp_bytes: int | None = None,
        verbose: bool = False,
    ):
        self.scoring = scoring or make_scoring_config("blosum62")
        self.num_top = num_top
        self.device = resolve_device(device)
        self.max_device_bytes = max_device_bytes
        self.col_temp_bytes = col_temp_bytes
        self.verbose = verbose
        dc = os.environ.get(DEBUG_CHECK_ENV, "0")
        if dc.lower() == "full":
            raise NotImplementedError(
                "the full-database debug check waits for the int16-state "
                "slice of the port (its verifiers come together)"
            )
        self.debug_check = dc not in ("", "0")
        # Alphabet padding code: 20 classic, 25 full-blosum.
        self._pad = self.scoring.pad_code
        self.db: DBData | None = None
        self.packed: PackedDB | None = None
        self._bucket_tiles: list[torch.Tensor] = []
        self._total_t0 = None
        self._total_cells = 0.0

    # ------------------------------------------------------------------ DB

    def _device_budget(self) -> int:
        """Device-memory budget for resident tiles, in bytes."""
        if self.max_device_bytes is not None:
            return self.max_device_bytes
        if self.device.type == "cuda":
            total = torch.cuda.get_device_properties(self.device).total_memory
            return int(total * 0.7)
        return 8 << 30

    def set_database(self, db: DBData, pack_cache: str | None = None,
                     packed: PackedDB | None = None) -> None:
        """Pack the database and make it resident on the device.

        ``packed``: use this packed form of ``db`` instead of packing it
        (``db.packing.packed_from_arrays`` builds one from plain arrays).
        """
        if pack_cache:
            raise NotImplementedError(
                "pack_cache (the JAX package's tile-store sidecar) waits for "
                "the disk-store slice of the port"
            )
        t0 = time.perf_counter()
        self.db = db
        self._bucket_tiles = []
        self.packed = packed if packed is not None else pack_db(db, pad_code=self._pad)
        if self.packed.total_padded_chars > self._device_budget():
            raise NotImplementedError(
                f"a packed database of {self.packed.total_padded_chars} bytes "
                f"exceeds the device budget of {self._device_budget()} bytes; "
                "streaming waits for a later slice of the port"
            )
        dev = self.device
        self._matrix_flat = torch.as_tensor(
            self.scoring.matrix.astype(np.int32).reshape(-1)
        ).to(dev)
        self._bucket_tiles = [
            torch.as_tensor(b.tiles).to(dev) for b in self.packed.buckets
        ]
        flat_idx = np.concatenate(
            [b.seq_index.reshape(-1) for b in self.packed.buckets]
        ) if self.packed.buckets else np.zeros(0, np.int32)
        self._flat_idx = torch.as_tensor(flat_idx.astype(np.int64)).to(dev)
        self._valid = self._flat_idx >= 0
        self._kinds = tuple(bucket_kind(b) for b in self.packed.buckets)
        if self.verbose:
            dt = time.perf_counter() - t0
            print(
                f"Database ready: {self.packed.num_sequences} sequences, "
                f"{self.packed.total_real_chars} residues, "
                f"{len(self.packed.buckets)} buckets, pack time {dt:.2f}s"
            )

    def warmup(self) -> int:
        """Build and load the CUDA kernel library ahead of the first scan
        (the port's counterpart of pre-compiling the kernel programs).
        Returns the number of libraries loaded (0 on the CPU)."""
        if self.device.type != "cuda":
            return 0
        from .ops import cuda_lib

        cuda_lib.lib()
        return 1

    @property
    def results_per_query(self) -> int:
        n = self.packed.num_sequences if self.packed else 0
        return max(0, min(self.num_top, n))

    def num_sequences(self) -> int:
        return self.packed.num_sequences if self.packed else 0

    def get_reference_header(self, ref_id: int) -> str:
        return self.db.get_header(int(ref_id))

    def get_reference_length(self, ref_id: int) -> int:
        return int(self.db.lengths[int(ref_id)])

    def get_reference_sequence(self, ref_id: int) -> str:
        return decode(self.db.get_sequence(int(ref_id)))

    # ---------------------------------------------------------------- scan

    def _single_qpad(self, codes):
        """Query block and params for a single scan: the query padded with
        the pad code to QCAP (the kernels stop at nq, and the plain
        versions never walk padded rows), and params
        [nq, gop, gex, nq_pad], nq_pad rounded up to the col kernel's row
        granule."""
        qpad, nq = prepare_query(codes, pad=self._pad)
        params = np.array(
            [nq, self.scoring.gop, self.scoring.gex, sw_col.padded_rows(nq)], dtype=np.int32
        )
        return qpad, params

    def slot_scores(self, codes) -> torch.Tensor:
        """Scores f32 of every slot of the packed database, in slot order
        (bucket, tile, lane), on the device; padding slots hold whatever
        the kernels gave them (mask with ``seq_index >= 0``)."""
        codes = np.asarray(codes, dtype=np.int8)
        if len(codes) > sw_cell.QCAP:
            raise NotImplementedError(
                f"a query of {len(codes)} residues exceeds QCAP={sw_cell.QCAP}; "
                "long queries (_scan_long_query) wait for a later slice of the port"
            )
        qpad, params = self._single_qpad(codes)
        qdev = cuda_lib.to_device(qpad, self.device)
        nq_pad = int(params[3])
        parts = []
        for tiles, kind in zip(self._bucket_tiles, self._kinds):
            if kind == "col" and nq_pad > sw_col.NQC:
                # Queries beyond the col kernel's row capacity: NQC-row
                # chunks with the H/F boundary carry.
                s = sw_col.score_bucket_col_any_query(
                    tiles, codes, self._matrix_flat,
                    self.scoring.gop, self.scoring.gex,
                    pad=self._pad, temp_bytes=self.col_temp_bytes,
                )
            else:
                s = score_bucket(tiles, qdev, self._matrix_flat, params, kind)
            parts.append(s.reshape(-1))
        if not parts:
            return torch.zeros(0, dtype=torch.float32, device=self.device)
        return torch.cat(parts)

    def _top_n(self, scores: torch.Tensor):
        """Top ``max(1, results_per_query)`` slots by descending score, then
        ascending slot (= ascending reference id): one int64 key per slot,
        (score + 1) << 32 | (2^32 - 1 - slot), so the order is total and
        needs no tie rule from topk.  Returns device (scores, ids)."""
        k = max(1, self.results_per_query)
        n = scores.numel()
        if n == 0:
            empty = torch.zeros(0, dtype=torch.int64, device=self.device)
            return empty, empty
        s = torch.where(self._valid, scores.long(), -1) + 1
        slot = torch.arange(n, dtype=torch.int64, device=self.device)
        key = (s << 32) | ((1 << 32) - 1 - slot)
        top = torch.topk(key, min(k, n)).values
        vals = (top >> 32) - 1
        slots = (1 << 32) - 1 - (top & ((1 << 32) - 1))
        return vals, self._flat_idx[slots]

    def _dispatch(self, codes):
        """Launch one query's scan; returns device (scores, ids)."""
        return self._top_n(self.slot_scores(codes))

    def _result(self, vals, ids, nq: int, seconds: float) -> ScanResult:
        k = self.results_per_query
        cells = float(nq) * float(self.packed.total_real_chars)
        self._total_cells += cells
        return ScanResult(
            scores=[int(v) for v in vals[:k]],
            reference_ids=[int(i) for i in ids[:k]],
            stats=BenchmarkStats(
                seconds=seconds,
                gcups=cells / 1e9 / seconds if seconds > 0 else 0.0,
            ),
        )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _encode(self, sequence):
        if isinstance(sequence, (str, bytes)):
            return encode(sequence)
        return np.asarray(sequence, np.int8)

    def scan(self, sequence) -> ScanResult:
        """Search one query against the resident database."""
        if self.packed is None:
            raise RuntimeError("set_database() must be called before scan()")
        codes = self._encode(sequence)
        t0 = time.perf_counter()
        vals, ids = self._dispatch(codes)
        self._sync()
        seconds = time.perf_counter() - t0
        result = self._result(vals.tolist(), ids.tolist(), len(codes), seconds)
        if self.debug_check:
            self._debug_check_result(codes, result)
        return result

    def scan_many(self, sequences, window: int = 3):
        """Pipelined scans: yields one ScanResult per input sequence, in
        order.  Up to ``window`` queries are launched ahead of reading
        their results back, so the host's work on the next query overlaps
        the device's.  Each query runs alone (the singles branch of the
        JAX engine's scan_many); multi-query batch kernels are a later
        slice of the port.  On CUDA a query's seconds are the device time
        from its first kernel to its top-N (CUDA events), so queued
        queries do not count each other's time; on the CPU, wall time."""
        if self.packed is None:
            raise RuntimeError("set_database() must be called before scan_many()")
        cuda = self.device.type == "cuda"
        pending: deque = deque()

        def materialize(entry):
            vals, ids, codes, clock = entry
            vals, ids = vals.tolist(), ids.tolist()  # waits for the query
            seconds = clock[0].elapsed_time(clock[1]) / 1e3 if cuda else clock
            result = self._result(vals, ids, len(codes), seconds)
            if self.debug_check:
                self._debug_check_result(codes, result)
            return result

        for sequence in sequences:
            codes = self._encode(sequence)
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                vals, ids = self._dispatch(codes)
                stop.record()
                clock = (start, stop)
            else:
                t0 = time.perf_counter()
                vals, ids = self._dispatch(codes)
                clock = time.perf_counter() - t0
            pending.append((vals, ids, codes, clock))
            if len(pending) > window:
                yield materialize(pending.popleft())
        while pending:
            yield materialize(pending.popleft())

    def _debug_check_result(self, codes, result: ScanResult) -> None:
        """Re-score the top-N hits with the scalar CPU oracle and raise on
        any difference (the reference's CUDASW_DEBUG_CHECK_CORRECTNESS)."""
        from .ops.oracle import sw_score_scalar

        for score, ref in zip(result.scores, result.reference_ids):
            want = sw_score_scalar(
                codes, self.db.get_sequence(int(ref)),
                self.scoring.matrix, self.scoring.gop, self.scoring.gex,
            )
            if int(score) != int(want):
                raise AssertionError(
                    f"debug check failed: refId {ref} scored {score}, "
                    f"oracle says {want}"
                )

    # --------------------------------------------------------------- timer

    def total_timer_start(self):
        self._total_t0 = time.perf_counter()
        self._total_cells = 0.0

    def total_timer_stop(self) -> BenchmarkStats:
        self._sync()
        seconds = time.perf_counter() - (self._total_t0 or time.perf_counter())
        gcups = self._total_cells / 1e9 / seconds if seconds > 0 else 0.0
        return BenchmarkStats(seconds=seconds, gcups=gcups)

    # ---------------------------------------------------------------- info

    def print_db_info(self):
        p = self.packed
        print(f"DB: {p.num_sequences} sequences, {p.total_real_chars} residues")
        print(
            f"Packed: {len(p.buckets)} buckets, padded chars "
            f"{p.total_padded_chars} "
            f"({p.total_padded_chars / max(1, p.total_real_chars):.2f}x)"
        )

    def print_db_length_partitions(self):
        for b in self.packed.buckets:
            print(
                f"  bucket L={b.L:6d} NS={b.NS:5d} tiles={b.num_tiles:6d} "
                f"sequences={b.num_real}"
            )
