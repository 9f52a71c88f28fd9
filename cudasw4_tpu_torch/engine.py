"""Search engine: a database resident on one device, single and batched
scans, top-N, stats (the counterpart of the resident single-device path of
cudasw4_tpu/engine.py).

Scan flow: encode the query -> score every bucket on its kernel (cell,
row or col; col buckets chunk queries longer than NQC with the H/F carry;
a query longer than QCAP grows its block in QCAP steps on cell and row
buckets, as the JAX engine's ``_scan_long_query`` does) -> concatenate
the scores in slot order (slot order is ascending reference id) -> mask
padding slots -> top N by descending score, then ascending id.  With
``state16`` (``CUDASW4_TPU_TORCH_STATE16=1``, ``align --dpx``) singles run
int16 state on cell and col buckets; when the top score reaches SAT, only
the tiles whose max reaches it are re-scored with exact state and merged
(``_rescore_overflow``).  Queries longer than QCAP run exact.
A batch of up to QB_MAX queries of at most ``_qcap_batch`` residues scores
each bucket in one launch for all of them: the cell batch kernel on cell
buckets, one flat-pool launch per ``col_flat_plan`` pass on col buckets,
the row kernel per query on row buckets.  ``scan_many`` groups its queries
so, as the JAX engine's does.
A database whose packed tiles and a streamed pass's working memory
exceed the device budget streams instead (engine_streaming.py): a
resident prefix stays on the device, the rest crosses the link once per
batch of up to QB_STREAM queries of any length.
GCUPS = query length x sum of real DB lengths / 1e9 / seconds, as the
reference's makeBenchmarkStats (src/cudasw4.cuh:2264-2271).

The engine runs on the card unless the caller asks for the CPU
(``device="cpu"``), where every wrapper takes its kernel's plain version.
Paths of the JAX engine that later slices of the port bring (several
devices, tuning, warmup) raise NotImplementedError naming their slice.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from . import engine_streaming
from .constants import decode, encode
from .db.format import DBData
from .db.packing import PackedDB, pack_db
from .engine_streaming import StreamingEngineMixin, upload
from .ops import (
    batch_col_scores, bucket_kind, col_flat_plan, cuda_lib, score_bucket, sw_cell, sw_col,
)
from .ops.sw_row import prepare_query
from .substitution import ScoringConfig, make_scoring_config

#: Environment switch of the oracle check: "1" re-scores each scan's top
#: hits on the scalar CPU oracle and raises on a mismatch; "full" diffs
#: every database score against the vectorised oracle (num_top is forced
#: to the database size).
DEBUG_CHECK_ENV = "CUDASW4_TPU_TORCH_DEBUG_CHECK"

#: Environment switch of int16 DP state with the overflow re-score ("1").
STATE16_ENV = "CUDASW4_TPU_TORCH_STATE16"

@dataclass
class BenchmarkStats:
    seconds: float = 0.0
    gcups: float = 0.0
    num_overflows: int = 0  # top-N hits that saturated int16 state and
    #                         were re-scored exactly with int32 state


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


class SearchEngine(StreamingEngineMixin):
    """One-device search engine: a resident database, or a streamed one
    past the device budget (engine_streaming.py)."""

    #: Queries per batched scan (short queries only): one launch per bucket
    #: serves the whole group.
    QB_MAX = 16

    #: Queries per streamed pass, of any length (engine_streaming.py).
    QB_STREAM = engine_streaming.QB_STREAM

    def __init__(
        self,
        scoring: ScoringConfig | None = None,
        num_top: int = 10,
        device=None,
        max_device_bytes: int | None = None,
        col_temp_bytes: int | None = None,
        stream_chunk_bytes: int = engine_streaming.STREAM_CHUNK_BYTES,
        max_batch_sequences: int | None = None,
        verbose: bool = False,
    ):
        self.scoring = scoring or make_scoring_config("blosum62")
        self.num_top = num_top
        self.device = resolve_device(device)
        self.max_device_bytes = max_device_bytes
        self.col_temp_bytes = col_temp_bytes
        # Streamed chunks hold at most stream_chunk_bytes of tiles
        # (--maxBatchBytes) and max_batch_sequences subject slots
        # (--maxBatchSequences), the two caps of the reference's copy plan.
        self.stream_chunk_bytes = stream_chunk_bytes
        self.max_batch_sequences = max_batch_sequences
        self.verbose = verbose
        self.streaming = False
        # A streamed pass's working memory and the cap of its kernels' tile
        # groups' temporaries (engine_streaming.stream_work_bytes); None
        # when resident: the kernels' own cap, cuda_lib.TEMP_BYTES.
        self._work_bytes = 0
        self._temp_bytes = None
        # int16 DP state with the overflow re-score (the reference's
        # 16-bit kernel families); off by default, as in the JAX engine.
        self.state16 = os.environ.get(STATE16_ENV, "0") == "1"
        dc = os.environ.get(DEBUG_CHECK_ENV, "0")
        self.debug_check = (
            None if dc in ("", "0") else ("full" if dc.lower() == "full" else "top")
        )
        # Alphabet padding code: 20 classic, 25 full-blosum.
        self._pad = self.scoring.pad_code
        self.db: DBData | None = None
        self.packed: PackedDB | None = None
        self._bucket_tiles: list[torch.Tensor] = []
        self._flat_idx = self._valid = None
        self._total_t0 = None
        self._total_cells = 0.0

    # ------------------------------------------------------------------ DB

    def _device_budget(self) -> int:
        """Device-memory budget, in bytes: the resident database, or a
        streamed one's prefix and a pass's working memory."""
        if self.max_device_bytes is not None:
            return self.max_device_bytes
        if self.device.type == "cuda":
            total = torch.cuda.get_device_properties(self.device).total_memory
            return int(total * 0.7)
        return 8 << 30

    def set_database(self, db: DBData, pack_cache: str | None = None,
                     packed: PackedDB | None = None) -> None:
        """Pack the database and make it resident on the device, or stream
        it when its packed tiles and a streamed pass's working memory
        (``engine_streaming.stream_work_bytes``) exceed the device budget.

        ``pack_cache``: the tile store's path (align passes
        ``<db>0.tpupack.npz``): loaded when it is fresh, else packed into
        it, with the transfer-pack sidecar in the same pass when the bucket
        plan already shows that the database streams; a store that cannot
        be written is skipped.  ``packed``: use this packed form of ``db``
        instead (``db.packing.packed_from_arrays`` builds one from plain
        arrays).
        """
        from .db import packing
        from .ops.pack5 import STREAM_PACK_ENV, choose_codec

        t0 = time.perf_counter()
        self.db = db
        if self.debug_check == "full" and self.num_top < db.num_sequences:
            # The reference's debug build forces numTop to the DB size so
            # the comparison covers every score.
            self.num_top = int(db.num_sequences)
        # A previous database's device tiles, prefix and transfer pack go
        # first, whichever branch this one takes.
        self.streaming = False
        self.packed = None
        self._bucket_tiles = []
        self._flat_idx = self._valid = None
        self._resident_chunks, self._res_tiles = [], {}
        self._stream_pack = self._stream_codec = None
        self._prefix_bytes, self._work_bytes, self._temp_bytes = 0, 0, None
        codec_mode = os.environ.get(STREAM_PACK_ENV, "1")
        if packed is None and pack_cache:
            lengths = np.asarray(db.lengths, np.int64)
            stream_codec = None
            try:
                if self._streams(packing.planned_shapes(lengths)):
                    stream_codec = choose_codec(codec_mode, int(self._pad))
            except ValueError:
                pass  # unsorted metadata: the store build raises it below
            packed = packing.load_packed(pack_cache, db.num_sequences, int(lengths.sum()),
                                         expect_pad=self._pad)
            if packed is not None and self.verbose:
                print(f"Loaded packed tiles from {pack_cache}")
            if packed is None:
                try:
                    packed = packing.pack_db_to_store(db, pack_cache, pad_code=self._pad,
                                                      stream_codec=stream_codec)
                except OSError:
                    packed = None  # a read-only database directory: pack in RAM
        self.packed = packed if packed is not None else pack_db(db, pad_code=self._pad)
        dev = self.device
        self._matrix_flat = torch.as_tensor(
            self.scoring.matrix.astype(np.int32).reshape(-1)
        ).to(dev)
        self._kinds = tuple(bucket_kind(b) for b in self.packed.buckets)
        shapes = [(b.L, b.NS, b.kernel, b.num_tiles) for b in self.packed.buckets]
        if self._streams(shapes):
            self.streaming = True
            self._work_bytes, self._temp_bytes = self._stream_work(shapes)
            self._stream_codec = choose_codec(codec_mode, int(self._pad))
            # The prefix first: a temp transfer pack then skips its tiles.
            self._load_resident_prefix()
            if self._stream_codec:
                with contextlib.ExitStack() as lock:
                    if pack_cache:
                        try:  # processes sharing the sidecar build it once
                            lock.enter_context(
                                packing._store_build_lock(pack_cache + ".pack5.build"))
                        except OSError:
                            pass  # no lock where the directory takes none
                    self._stream_pack = self._build_stream_pack(pack_cache)
            if self.verbose:
                print("Database exceeds device memory budget: streaming mode")
        else:
            self._bucket_tiles = [upload(b.tiles, dev) for b in self.packed.buckets]
            flat_idx = np.concatenate(
                [b.seq_index.reshape(-1) for b in self.packed.buckets]
            ) if self.packed.buckets else np.zeros(0, np.int32)
            self._flat_idx = torch.as_tensor(flat_idx.astype(np.int64)).to(dev)
            self._valid = self._flat_idx >= 0
        if self.verbose:
            dt = time.perf_counter() - t0
            print(
                f"Database ready: {self.packed.num_sequences} sequences, "
                f"{self.packed.total_real_chars} residues, "
                f"{len(self.packed.buckets)} buckets, pack time {dt:.2f}s"
            )

    def _streams(self, shapes) -> bool:
        """``engine_streaming.streams`` under this engine's budget and
        chunk caps."""
        return engine_streaming.streams(shapes, self._device_budget(), self.stream_chunk_bytes,
                                        self.max_batch_sequences, self.QB_STREAM)

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
        the pad code to QCAP, or to the next multiple of QCAP for a longer
        query (the kernels stop at nq, and the plain versions never walk
        padded rows), and params [nq, gop, gex, nq_pad], nq_pad rounded up
        to the col kernel's row granule."""
        cap = sw_cell.QCAP
        qpad, nq = prepare_query(codes, qcap=max(cap, -(-len(codes) // cap) * cap), pad=self._pad)
        params = np.array(
            [nq, self.scoring.gop, self.scoring.gex, sw_col.padded_rows(nq)], dtype=np.int32
        )
        return qpad, params

    def _exact_for(self, codes) -> bool:
        """Whether a single scan of ``codes`` runs exact int32 state: always
        without ``state16``, and for queries longer than QCAP (as the JAX
        engine's ``_scan_long_query``)."""
        return not self.state16 or len(codes) > sw_cell.QCAP

    def _score_bucket(self, tiles, kind, codes, qdev, params, exact: bool):
        """Scores f32 [T, NS] of one query against one bucket's tiles: col
        buckets take NQC-row chunks with the H/F carry when the query's
        padded rows pass NQC, every other case one kernel call.  A streamed
        pass caps the tile groups' temporaries at ``_temp_bytes``: the
        carry's groups at half of it, as its in and out carries live
        together."""
        if kind == "col" and int(params[3]) > sw_col.NQC:
            temp = self.col_temp_bytes
            if self._temp_bytes is not None:
                half = self._temp_bytes // 2
                temp = half if temp is None else min(temp, half)
            return sw_col.score_bucket_col_any_query(
                tiles, codes, self._matrix_flat, self.scoring.gop, self.scoring.gex,
                pad=self._pad, temp_bytes=temp, exact=exact,
            )
        return score_bucket(tiles, qdev, self._matrix_flat, params, kind, exact=exact,
                            temp_bytes=self._temp_bytes)

    def bucket_scores(self, codes, exact: bool = True) -> list[torch.Tensor]:
        """Scores f32 [T, NS] of one query against each bucket, in bucket
        order, on the device; ``exact=False``: int16 state (cell and col
        buckets)."""
        if self.streaming:
            raise RuntimeError("bucket scores need a resident database; a streamed "
                               "one yields its scores chunk by chunk (_stream_rows)")
        codes = np.asarray(codes, dtype=np.int8)
        qpad, params = self._single_qpad(codes)
        qdev = cuda_lib.to_device(qpad, self.device)
        return [
            self._score_bucket(tiles, kind, codes, qdev, params, exact)
            for tiles, kind in zip(self._bucket_tiles, self._kinds)
        ]

    def slot_scores(self, codes, exact: bool = True) -> torch.Tensor:
        """Scores f32 of every slot of the packed database, in slot order
        (bucket, tile, lane), on the device; padding slots hold whatever
        the kernels gave them (mask with ``seq_index >= 0``)."""
        return self._slots(self.bucket_scores(codes, exact))

    def _slots(self, parts) -> torch.Tensor:
        """Per-bucket scores [T, NS] flattened into one slot-order vector."""
        if not parts:
            return torch.zeros(0, dtype=torch.float32, device=self.device)
        return torch.cat([p.reshape(-1) for p in parts])

    def _top_n(self, scores: torch.Tensor, ids: torch.Tensor | None = None):
        """Top ``max(1, results_per_query)`` slots of each row of ``scores``
        ([N] or [S, N]) by descending score, then ascending slot (=
        ascending reference id): one int64 key per slot,
        (score + 1) << 32 | (2^32 - 1 - slot), so the order is total and
        needs no tie rule from topk.  ``ids``: int64 [N] reference id of
        each slot, -1 for padding (default: the resident database's).
        Returns device (scores, ids); padding slots that make up a short
        row come out as (-1, -1)."""
        ids = self._flat_idx if ids is None else ids
        k = max(1, self.results_per_query)
        n = scores.shape[-1]
        if n == 0:
            empty = torch.zeros(scores.shape, dtype=torch.int64, device=self.device)
            return empty, empty
        s = torch.where(ids >= 0, scores.long(), -1) + 1
        slot = torch.arange(n, dtype=torch.int64, device=self.device)
        key = (s << 32) | ((1 << 32) - 1 - slot)
        top = torch.topk(key, min(k, n), dim=-1).values
        vals = (top >> 32) - 1
        slots = (1 << 32) - 1 - (top & ((1 << 32) - 1))
        return vals, ids[slots]

    def _dispatch(self, codes):
        """Launch one query's scan; returns device (scores, ids, tile
        maxima), the tile maxima [T] per bucket for an int16-state scan and
        None for an exact one."""
        exact = self._exact_for(codes)
        parts = self.bucket_scores(codes, exact)
        vals, ids = self._top_n(self._slots(parts))
        return vals, ids, None if exact else [p.amax(dim=1) for p in parts]

    def _result(self, vals, ids, nq: int, seconds: float, overflows: int = 0) -> ScanResult:
        k = self.results_per_query
        cells = float(nq) * float(self.packed.total_real_chars)
        self._total_cells += cells
        return ScanResult(
            scores=[int(v) for v in vals[:k]],
            reference_ids=[int(i) for i in ids[:k]],
            stats=BenchmarkStats(
                seconds=seconds,
                gcups=cells / 1e9 / seconds if seconds > 0 else 0.0,
                num_overflows=overflows,
            ),
        )

    def _finish_single(self, codes, vals, ids, tmaxes):
        """Host (vals, ids, overflows) of a single scan: the fast pass's
        top-N, and when its top score reaches SAT the re-scored merge
        (``_rescore_overflow``), overflows counting the fast top-N entries
        at or above SAT.  Reads the device results back."""
        vals, ids = vals.tolist(), ids.tolist()
        if tmaxes is None or not vals or vals[0] < sw_cell.SAT:
            return vals, ids, 0
        overflows = sum(1 for v in vals if v >= sw_cell.SAT)
        vals, ids = self._rescore_overflow(tmaxes, vals, ids, codes)
        return vals, ids, overflows

    def _rescore_overflow(self, tmaxes, vals, ids, codes):
        """Exact int32 re-score of only the tiles whose int16 max reached
        SAT, merged into the fast pass's top-N by (-score, id) (the JAX
        engine's single-device ``_rescore_overflow``; the mesh twin waits
        for the multi-GPU slice).

        A saturated subject's exact score is >= SAT and every unsaturated
        score is exact and < SAT, so the true top-N is the exact scores of
        the flagged tiles' subjects merged with the fast top-N less its
        entries from those tiles.  Returns host (vals, ids)."""
        sat = sw_cell.SAT
        qpad, params = self._single_qpad(codes)
        qdev = cuda_lib.to_device(qpad, self.device)
        cand_v, cand_i = [], []
        for b, tiles, kind, tmax in zip(self.packed.buckets, self._bucket_tiles,
                                        self._kinds, tmaxes):
            sel = torch.nonzero(tmax >= sat).flatten()
            if sel.numel() == 0:
                continue
            s = self._score_bucket(tiles.index_select(0, sel), kind, codes, qdev, params, True)
            sidx = b.seq_index[sel.cpu().numpy()].reshape(-1)
            s = s.reshape(-1).cpu().numpy()
            keep = sidx >= 0
            cand_v.append(s[keep].astype(np.int64))
            cand_i.append(sidx[keep].astype(np.int64))
        if not cand_v:  # a flag without a flagged tile cannot happen
            return vals, ids
        vals, ids = np.asarray(vals, np.int64), np.asarray(ids, np.int64)
        keep = ~np.isin(ids, np.concatenate(cand_i))
        allv = np.concatenate([vals[keep], *cand_v])
        alli = np.concatenate([ids[keep], *cand_i])
        order = np.lexsort((alli, -allv))[: len(vals)]
        return allv[order].tolist(), alli[order].tolist()

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
        if self.streaming:  # one pass of the streamed batch, exact state
            return self._scan_streaming_batch([codes])[0]
        t0 = time.perf_counter()
        vals, ids, overflows = self._finish_single(codes, *self._dispatch(codes))
        self._sync()
        seconds = time.perf_counter() - t0
        result = self._result(vals, ids, len(codes), seconds, overflows)
        if self.debug_check:
            self._debug_check_result(codes, result)
        return result

    def _timed(self, fn, *args):
        """Run ``fn(*args)``; returns (its result, its clock): CUDA events
        around its launches on the card, so work queued before it does not
        count, and its wall seconds on the CPU."""
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            return fn(*args), time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        stop.record()
        return out, (start, stop)

    @staticmethod
    def _seconds(clock) -> float:
        """Seconds of a clock from ``_timed`` (waits for its events)."""
        if isinstance(clock, tuple):
            return clock[0].elapsed_time(clock[1]) / 1e3
        return clock

    # ------------------------------------------------------------ batching

    @property
    def _qb_cap(self) -> int:
        """Most queries scan_batch and scan_many group into one batch."""
        return self.QB_STREAM if self.streaming else self.QB_MAX

    @property
    def _qcap_batch(self) -> int:
        """Longest query a batch takes (``engine_streaming.batch_rows``)."""
        return engine_streaming.batch_rows({b.kernel for b in self.packed.buckets})

    def _batch_slot_params(self, entries, QB: int, width: int):
        """The batch kernels' layout: ``entries`` = (slot, codes) pairs ->
        (queries [QB, width] int32, nqs, pads, params [4 + 2*QB] =
        [0, gop, gex, 0] + nqs + pads), pads being the rows rounded up to
        the unroll (at least one granule)."""
        queries = np.full((QB, width), self._pad, dtype=np.int32)
        nqs = np.zeros(QB, np.int32)
        cu = sw_col.DEFAULT_UNROLL
        pads = np.full(QB, cu, np.int32)
        for slot, c in entries:
            queries[slot, : len(c)] = c
            nqs[slot] = len(c)
            pads[slot] = sw_col.padded_rows(len(c), cu)
        params = np.concatenate(
            [np.array([0, self.scoring.gop, self.scoring.gex, 0], np.int32), nqs, pads]
        )
        return queries, nqs, pads, params

    def batch_slot_scores(self, group) -> torch.Tensor:
        """Scores f32 [len(group), slots] of a batch of encoded queries,
        each of at most ``_qcap_batch`` residues, against every slot of the
        packed database (as ``slot_scores`` gives them for one query).

        The group's slots only are launched: the JAX engine pads its batch
        to QB_MAX slots to keep one compiled program, which the port does
        not need.  Each bucket is its own launch, which is the JAX engine's
        split dispatch (BATCH_SPLIT_CELLS) at every size."""
        if self.streaming:
            raise RuntimeError("batch slot scores need a resident database")
        S = len(group)
        qcap_b = self._qcap_batch
        queries, nqs, pads, params = self._batch_slot_params(enumerate(group), S, qcap_b)
        plan = ()
        if any(k == "col" for k in self._kinds):
            plan = col_flat_plan(pads, limit=S, rtot=qcap_b)
        batch = (cuda_lib.to_device(queries, self.device), nqs, pads, params, plan)
        parts = [self._batch_bucket(tiles, kind, *batch)
                 for tiles, kind in zip(self._bucket_tiles, self._kinds)]
        if not parts:
            return torch.zeros((S, 0), dtype=torch.float32, device=self.device)
        return torch.cat(parts, dim=1)

    def _batch_bucket(self, tiles, kind, qdev, nqs, pads, params, plan) -> torch.Tensor:
        """Scores f32 [S, T x NS] of a batch's S slots (``_batch_slot_params``
        layout, queries ``qdev`` on the device, ``plan`` from col_flat_plan
        on a database with col buckets) against one bucket's tiles: the
        cell batch kernel on cell tiles, one flat-pool launch per plan pass
        on col tiles, the row kernel per slot on row tiles."""
        S = qdev.shape[0]
        if kind == "cell":
            s = sw_cell.score_bucket_cell_batch(tiles, qdev, self._matrix_flat, params)
        elif kind == "col":
            got = [None] * S
            for s_part, slots in batch_col_scores(
                tiles, qdev, self._matrix_flat, params, S, plan, rtot=self._qcap_batch,
                temp_bytes=self._temp_bytes,
            ):
                for si, slot in enumerate(slots):
                    got[slot] = s_part[si]
            s = torch.stack(got)
        else:
            gop, gex = self.scoring.gop, self.scoring.gex
            s = torch.stack([
                score_bucket(tiles, qdev[i], self._matrix_flat,
                             (int(nqs[i]), gop, gex, int(pads[i])), kind)
                for i in range(S)
            ])
        return s.reshape(S, -1)

    def _dispatch_batch(self, group):
        """Launch one batch; returns device (scores, ids), each [S, k]
        (batches are exact)."""
        return self._top_n(self.batch_slot_scores(group))

    def _materialize_batch(self, vals, ids, group, clock) -> list[ScanResult]:
        """Per-query ScanResults of one batch, in order.  A query's seconds
        are the batch's split in proportion to its cells (queries are not
        separately observable inside one batch)."""
        vals, ids = vals.tolist(), ids.tolist()  # waits for the batch
        seconds = self._seconds(clock)
        total = sum(len(c) for c in group)
        out = [
            self._result(v, i, len(c), seconds * len(c) / total if total else seconds)
            for v, i, c in zip(vals, ids, group)
        ]
        if self.debug_check:
            for c, r in zip(group, out):
                self._debug_check_result(c, r)
        return out

    def scan_batch(self, sequences) -> list[ScanResult]:
        """Scan up to QB_MAX queries of at most ``_qcap_batch`` residues as
        one batch (synchronous); returns results in input order.  A
        streamed database takes up to QB_STREAM queries of any length in
        one pass."""
        group = [self._encode(s) for s in sequences]
        if len(group) > self._qb_cap:
            raise ValueError(
                f"scan_batch takes at most {self._qb_cap} queries per call "
                f"(got {len(group)}); use scan_many for larger sets"
            )
        if self.packed is None:
            raise RuntimeError("set_database() must be called before scan_batch()")
        if self.streaming:
            return self._scan_streaming_batch(group)
        too_long = [len(c) for c in group if len(c) > self._qcap_batch]
        if too_long:
            raise ValueError(
                f"scan_batch queries must be <= {self._qcap_batch} residues on a "
                f"resident DB (got {max(too_long)}); use scan() / scan_many for "
                "longer queries"
            )
        if not group:
            return []
        (vals, ids), clock = self._timed(self._dispatch_batch, group)
        return self._materialize_batch(vals, ids, group, clock)

    def scan_many(self, sequences, window: int = 3):
        """Pipelined scans: yields one ScanResult per input sequence, in
        order.  Queries of at most ``_qcap_batch`` residues are grouped into
        batches of up to QB_MAX; a group is launched when it is full or a
        longer query arrives, which then runs alone.  Under ``state16``
        every query runs alone (the batch kernels are exact), as in the JAX
        engine.  Up to ``window`` launches (batches or singles) are queued
        ahead of reading their results back, so the host's work overlaps
        the device's.  A single's seconds are its CUDA-event span on the
        card (its wall time on the CPU), plus its overflow re-score's; a
        batch's span is split over its queries by their cells.  A streamed
        database takes every query into its passes, QB_STREAM a pass, also
        under ``state16`` (streamed passes are exact), each pass synchronous.
        """
        if self.packed is None:
            raise RuntimeError("set_database() must be called before scan_many()")
        if self.streaming:
            group: list = []
            for sequence in sequences:
                group.append(self._encode(sequence))
                if len(group) >= self._qb_cap:
                    yield from self._scan_streaming_batch(group)
                    group = []
            yield from self._scan_streaming_batch(group)
            return
        pending: deque = deque()  # (group or None, (vals, ids, tmaxes), codes, clock)
        shortbuf: list = []
        qcap_b = self._qcap_batch if not self.state16 else -1

        def materialize(entry):
            group, out, codes, clock = entry
            if group is not None:
                return self._materialize_batch(*out, group, clock)
            # Reads the query back; a re-score is timed on its own.
            (vals, ids, overflows), clock2 = self._timed(self._finish_single, codes, *out)
            seconds = self._seconds(clock) + self._seconds(clock2)
            result = self._result(vals, ids, len(codes), seconds, overflows)
            if self.debug_check:
                self._debug_check_result(codes, result)
            return [result]

        def flush_shorts():
            if shortbuf:
                group = list(shortbuf)
                shortbuf.clear()
                out, clock = self._timed(self._dispatch_batch, group)
                pending.append((group, out, None, clock))

        for sequence in sequences:
            codes = self._encode(sequence)
            if len(codes) <= qcap_b:
                shortbuf.append(codes)
                if len(shortbuf) >= self._qb_cap:
                    flush_shorts()
                    while len(pending) > window:
                        yield from materialize(pending.popleft())
                continue
            flush_shorts()
            out, clock = self._timed(self._dispatch, codes)
            pending.append((None, out, codes, clock))
            if len(pending) > window:
                yield from materialize(pending.popleft())
        flush_shorts()
        while pending:
            yield from materialize(pending.popleft())

    def _debug_check_result(self, codes, result: ScanResult) -> None:
        """Re-score the top-N hits with the scalar CPU oracle and raise on
        any difference (the reference's CUDASW_DEBUG_CHECK_CORRECTNESS);
        with ``debug_check == "full"`` diff every score instead."""
        if self.debug_check == "full":
            return self._debug_check_full(codes, result)
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

    def _debug_check_full(self, codes, result: ScanResult) -> None:
        """Diff every database score against the vectorised CPU oracle
        (``CUDASW4_TPU_TORCH_DEBUG_CHECK=full``), the analog of the
        reference's computeAllScoresCPU comparison.  set_database forced
        num_top to the database size, so the result carries one (score, id)
        per sequence; a mismatch anywhere fails."""
        from .ops.oracle import sw_score_rowvec

        n = self.packed.num_sequences
        ids = np.asarray(result.reference_ids, dtype=np.int64)
        if len(result.scores) != n or len(np.unique(ids)) != n:
            raise AssertionError(
                f"full debug check expects one result per sequence: got "
                f"{len(result.scores)} results / {len(np.unique(ids))} "
                f"distinct ids for {n} sequences"
            )
        got = np.zeros(n, dtype=np.int64)
        got[ids] = np.asarray(result.scores, dtype=np.int64)
        lengths = np.asarray(self.db.lengths, dtype=np.int64)
        want = np.zeros(n, dtype=np.int64)
        chunk = 256  # equal-padded batches for the row oracle
        for a in range(0, n, chunk):
            b = min(a + chunk, n)
            subs = np.full((b - a, max(1, int(lengths[a:b].max()))), self._pad, dtype=np.int8)
            for i in range(a, b):
                s = self.db.get_sequence(i)
                subs[i - a, : len(s)] = s
            want[a:b] = sw_score_rowvec(
                codes, subs, self.scoring.matrix, self.scoring.gop, self.scoring.gex,
            )
        bad = np.nonzero(got != want)[0]
        if bad.size:
            head = ", ".join(f"refId {i}: got {got[i]}, oracle {want[i]}" for i in bad[:5])
            raise AssertionError(f"full debug check failed for {bad.size}/{n} sequences: {head}")

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
