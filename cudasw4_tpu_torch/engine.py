"""Search engine: a database resident on one device, single and batched
scans, top-N, stats (the counterpart of the resident single-device path of
cudasw4_tpu/engine.py).

Scan flow: encode the query -> score every bucket on its kernel (cell,
row or col; col buckets chunk queries longer than NQC with the H/F carry;
a query longer than QCAP grows its block in QCAP steps on cell and row
buckets, as the JAX engine's ``_scan_long_query`` does; every bucket
runs on its own kind for every query length, since the JAX engine's
routing of long singles onto the col kernel lost on the H100 at every
threshold) -> concatenate the scores in slot order (slot order is
ascending reference id) -> mask padding slots -> top N by descending
score, then ascending id.  With
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
With a ``mesh`` (parallel/sharding.py) every bucket's tiles split over
the mesh's shards, resident or streamed: each shard runs the same kernels
on its slice, reduces it to its top N, and the host merges the shards'
candidates under the same tie rule (``_dispatch_mesh``,
``_dispatch_batch_mesh``, ``_rescore_overflow_mesh``), so a mesh gives
exactly what one device gives.
GCUPS = query length x sum of real DB lengths / 1e9 / seconds, as the
reference's makeBenchmarkStats (src/cudasw4.cuh:2264-2271); a mesh counts
the database's residues once, not once a shard.

The engine runs on the card unless the caller asks for the CPU
(``device="cpu"``, or a mesh of CPU devices), where every wrapper takes
its kernel's plain version.  On a card it applies the packaged tuning
config of the device once, before it packs (``db.packing.auto_apply_tuning``).
``warmup=True`` launches every kernel instance a single scan of the
database reaches once, at ``set_database`` (``warmup``).

Every scan's seconds are host-clock seconds, from its launch to its result
on the host; a launch of ``scan_many`` queued behind others counts from
the later of its launch and the previous result's arrival (``_seconds``),
so the per-query seconds of one call sum to at most its wall time.

Each layer boundary of a scan is a profiler span and, on a card, an NVTX
range (``utils.profiling.span``), all named ``sw:*``: ``sw:scan`` the
whole ``scan`` call; inside it ``sw:enqueue`` (the query upload, one
``sw:bucket <kind> L=<L>`` a bucket, the slot concatenation and the top N)
and ``sw:finish`` (the read-back, an overflow re-score, the wait for the
card and the result).  ``scan_many`` gives its singles the same
``sw:enqueue`` and ``sw:finish``, and its batches ``sw:scan_batch`` (one
``sw:batch_bucket <kind> L=<L>`` a bucket) and ``sw:finish``.  A streamed
pass's spans are listed in engine_streaming.py.  A mesh adds
``sw:shard <pos>`` around each shard's enqueue, and ``sw:shard_wait`` and
``sw:merge`` around the wait for the shards' candidates and their merge
(parallel/sharding.py); a single device gives none of them.
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
from .parallel import sharding
from .parallel.sharding import Candidates, shard_span
from .substitution import ScoringConfig, make_scoring_config
from .utils.profiling import span

#: Environment switch of the oracle check: "1" re-scores each scan's top
#: hits on the scalar CPU oracle and raises on a mismatch; "full" diffs
#: every database score against the vectorised oracle (num_top is forced
#: to the database size).
DEBUG_CHECK_ENV = "CUDASW4_TPU_TORCH_DEBUG_CHECK"

#: Environment switch of int16 DP state with the overflow re-score ("1").
STATE16_ENV = "CUDASW4_TPU_TORCH_STATE16"

#: Per-shard budget of a mesh that spans processes when no
#: max_device_bytes is given: every process must decide alike, and each
#: sees only its own devices.
MULTIPROCESS_BUDGET = 8 << 30

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


def _kernel_launches() -> int:
    """Launches so far of the single-scan kernels (B1 in both state modes,
    B2, B3 in both state modes)."""
    from .ops import sw_row

    return sum(getattr(fn, name, 0)
               for fn in (sw_cell.score_bucket_cell, sw_row.score_bucket_row,
                          sw_col.score_bucket_col)
               for name in ("launches", "launches16"))


def _merge_rescored(vals, ids, cand_v, cand_i):
    """The fast pass's top-N (``vals``, ``ids``) after an overflow re-score:
    its entries below SAT that were not re-scored, merged with the exact
    candidates (``cand_v``, ``cand_i``) by (-score, id) and cut to its
    length.  An entry at SAT is a lower bound, and its subject's tile was
    flagged: its exact score is among the candidates, or below a shard's
    top N.  Returns host (vals, ids)."""
    vals, ids = np.asarray(vals, np.int64), np.asarray(ids, np.int64)
    keep = (vals < sw_cell.SAT) & ~np.isin(ids, cand_i)
    allv = np.concatenate([vals[keep], np.asarray(cand_v, np.int64)])
    alli = np.concatenate([ids[keep], np.asarray(cand_i, np.int64)])
    order = np.lexsort((alli, -allv))[: len(vals)]
    return allv[order].tolist(), alli[order].tolist()


class SearchEngine(StreamingEngineMixin):
    """Search engine on one device or a mesh: a resident database, or a
    streamed one past the device budget (engine_streaming.py)."""

    #: Most flagged tiles of one bucket that one shard re-scores in the
    #: mesh overflow re-score; past it the query is scanned again in exact
    #: state (the JAX engine's OVF_TILE_CAP, the reference's overflow
    #: buffer).
    OVF_TILE_CAP = 32

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
        mesh: sharding.Mesh | None = None,
        qcap: int | None = None,
        bucket_edges=None,
        warmup: bool = False,
    ):
        self.scoring = scoring or make_scoring_config("blosum62")
        self.num_top = num_top
        # A mesh's shards hold the database; ``device`` is then its first
        # local device.
        self.mesh = mesh
        self.device = mesh.local_devices[0] if mesh is not None else resolve_device(device)
        # The query block of a single scan (default sw_cell.QCAP, read
        # now): a query grows it in steps of qcap, and one longer than qcap
        # runs exact state (the JAX engine's qcap).  bucket_edges: the
        # packing's bucket lengths (None: the default plan,
        # db.packing.plan_buckets).
        self.qcap = int(sw_cell.QCAP if qcap is None else qcap)
        if self.qcap < 1:
            raise ValueError(f"qcap must be positive, got {qcap}")
        self.bucket_edges = bucket_edges
        # Launch the kernel instances a single scan reaches at
        # set_database (align --warmup, --interactive; ``warmup``).
        self.warmup_on = warmup
        if self.device.type == "cuda":
            # The measured geometry of this card is the default, as the
            # reference's built-in dispatch table is; an explicit config
            # (CUDASW4_TPU_TORCH_TUNING, align --tuning) wins, and
            # CUDASW4_TPU_TORCH_AUTO_TUNING=0 opts out.
            from .db.packing import auto_apply_tuning

            auto_apply_tuning(torch.cuda.get_device_name(self.device), verbose=verbose)
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
        # Each bucket's subject lengths on the device where the col kernels
        # score it (sw_col.ColLengths), else None (``_col_lengths``).
        self._bucket_lengths: list = []
        self._flat_idx = self._valid = None
        self._shards: list[sharding.Shard] = []
        self._total_t0 = None
        self._total_cells = 0.0
        self._host_done = 0.0  # when the last scan_many result reached the host

    # ------------------------------------------------------------------ DB

    def _mesh_ndev(self) -> int:
        return self.mesh.size if self.mesh is not None else 1

    @property
    def shard_load(self) -> list[dict]:
        """What each local shard scores in a pass, set at placement
        (``sharding.count_load``): [{"shard", "tiles", "slots",
        "residues"}], slots being tiles x NS x L; empty without a mesh."""
        return [{"shard": sh.pos, "tiles": sh.num_tiles, "slots": sh.slots,
                 "residues": sh.residues} for sh in self._shards]

    def _device_budget(self) -> int:
        """Device-memory budget of one device (of each shard, on a mesh), in
        bytes: the resident database, or a streamed one's prefix and a
        pass's working memory.  A card's 0.7 is shared by the shards it
        holds; a mesh across processes takes MULTIPROCESS_BUDGET unless
        ``max_device_bytes`` is given."""
        if self.max_device_bytes is not None:
            return self.max_device_bytes
        if self.mesh is not None and self.mesh.multiprocess:
            return MULTIPROCESS_BUDGET
        devices = self.mesh.local_devices if self.mesh is not None else [self.device]
        if devices[0].type == "cuda":
            return min(int(torch.cuda.get_device_properties(d).total_memory * 0.7)
                       // devices.count(d) for d in devices)
        return 8 << 30

    def set_database(self, db: DBData, pack_cache: str | None = None,
                     packed: PackedDB | None = None) -> None:
        """Pack the database and make it resident on the device (split over
        the mesh's shards), or stream it when its packed tiles and a
        streamed pass's working memory (``engine_streaming.stream_work_bytes``)
        exceed the device budget (on a mesh: the largest shard's tiles and
        one shard's working memory against one shard's budget).

        ``pack_cache``: the tile store's path (align passes
        ``<db>0.tpupack.npz``): loaded when it is fresh, else packed into
        it, with the transfer-pack sidecar in the same pass when the bucket
        plan already shows that the database streams; a store that cannot
        be written is skipped.  A streamed mesh across processes packs only
        the tiles this process's shards read (a per-host store,
        ``_host_tile_ranges``), and a partial store that turns out resident is first
        extended to every tile.  ``packed``: use this packed form of ``db``
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
        self._bucket_lengths = []
        self._flat_idx = self._valid = None
        self._shards = []
        self._resident_chunks, self._res_tiles = [], {}
        self._stream_pack = self._stream_codec = None
        self._prefix_bytes, self._work_bytes, self._temp_bytes = 0, 0, None
        codec_mode = os.environ.get(STREAM_PACK_ENV, "1")
        if packed is None and pack_cache:
            lengths = np.asarray(db.lengths, np.int64)
            stream_codec = tile_ranges = None
            try:
                plans = packing.plan_buckets(lengths, self.bucket_edges)
                if self._streams([(L, NS, kernel, -(-(stop - start) // NS))
                                  for start, stop, L, NS, kernel in plans]):
                    stream_codec = choose_codec(codec_mode, int(self._pad))
                    tile_ranges = self._host_tile_ranges(plans)
            except ValueError:
                pass  # unsorted metadata: the store build raises it below
            packed = packing.load_packed(pack_cache, db.num_sequences, int(lengths.sum()),
                                         expect_pad=self._pad, need_ranges=tile_ranges)
            if packed is not None and self.verbose:
                print(f"Loaded packed tiles from {pack_cache}")
            if packed is None:
                try:
                    packed = packing.pack_db_to_store(db, pack_cache, edges=self.bucket_edges,
                                                      pad_code=self._pad,
                                                      stream_codec=stream_codec,
                                                      tile_ranges=tile_ranges)
                except OSError:
                    packed = None  # a read-only database directory: pack in RAM
        self.packed = (packed if packed is not None
                       else pack_db(db, edges=self.bucket_edges, pad_code=self._pad))
        shapes = [(b.L, b.NS, b.kernel, b.num_tiles) for b in self.packed.buckets]
        if self.packed.tile_ranges is not None and not self._streams(shapes):
            # The budget says resident after all: the partial store's
            # tiles are not all this process's shards' slices.
            self.packed = packing.pack_db_to_store(db, pack_cache, edges=self.bucket_edges,
                                                   pad_code=self._pad)
        dev = self.device
        matrix_flat = self.scoring.matrix.astype(np.int32).reshape(-1)
        self._matrix_flat = cuda_lib.device_matrix(matrix_flat, dev)
        self._kinds = tuple(bucket_kind(b) for b in self.packed.buckets)
        if self.mesh is not None:
            self._shards = sharding.make_shards(self.mesh, matrix_flat)
        if self._streams(shapes):
            self.streaming = True
            self._work_bytes, self._temp_bytes = self._stream_work(shapes)
            self._stream_codec = choose_codec(codec_mode, int(self._pad))
            # Every col bucket's lengths stay resident; a chunk views its own.
            if self.mesh is None:
                self._bucket_lengths = self._col_lengths(dev)
            for sh in self._shards:
                with sharding.shard_context(sh):
                    sh.stream_lengths = self._col_lengths(sh.device)
            # The prefix first: a temp transfer pack then skips its tiles.
            self._load_resident_prefix()
            if self.mesh is not None:
                sharding.count_load(self.packed, self._shards, self.mesh.size,
                                    self._chunk_tiles)
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
        elif self.mesh is not None:
            sharding.shard_bucket_arrays(self.packed, self._shards, self.mesh.size)
        else:
            self._bucket_tiles = [upload(b.tiles, dev) for b in self.packed.buckets]
            self._bucket_lengths = self._col_lengths(dev)
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
                + (f", {self.mesh.size} shards" if self.mesh is not None else "")
            )
        if self.warmup_on:
            self.warmup()

    def _col_lengths(self, device) -> list:
        """Each bucket's subject lengths on ``device`` (``sw_col.ColLengths``,
        16 KB a tile) where it is a col bucket, else None: every col launch
        on a bucket's tiles takes their share, so that no warp runs the
        passes past its own subject's length."""
        return [sw_col.ColLengths.place(b.lengths, device) if kind == "col" else None
                for b, kind in zip(self.packed.buckets, self._kinds)]

    def _streams(self, shapes) -> bool:
        """``engine_streaming.streams`` under this engine's budget and
        chunk caps."""
        return engine_streaming.streams(shapes, self._device_budget(), self.stream_chunk_bytes,
                                        self.max_batch_sequences, self.QB_STREAM,
                                        self._mesh_ndev())

    def warmup(self) -> int:
        """Launch, once, every kernel instance that a single scan of this
        database reaches, at the minimal query (one residue, one 8-row
        granule), so that no user query pays the first launches: the
        kernel library's build and load, each kernel's module load (CUDA
        loads modules lazily), PyTorch's top-N kernels and the caching
        allocator's first blocks (the JAX engine's ``warmup``, which
        compiles its programs).  Per bucket, on its own kind: B1 (both
        state modes under ``state16``), B2 on its route, B3 (both state
        modes under ``state16``); per col bucket also the carry variants of
        a query past NQC (``_warmup_col_chunked``).
        Batches are not warmed, as in the JAX engine.  A streamed or mesh
        database warms with one tiny scan.  Returns the kernel launches
        warmed: 0 on the CPU and with no buckets, 1 for the tiny scan."""
        if self.packed is None:
            raise RuntimeError("set_database() must be called first")
        t0 = time.perf_counter()
        if self.streaming or self.mesh is not None:
            self.scan([0])
            if self.verbose:
                print(f"warmup: 1 {'streaming' if self.streaming else 'mesh'} scan pass "
                      f"({time.perf_counter() - t0:.1f}s)")
            return 1
        if self.device.type != "cuda" or not self.packed.buckets:
            return 0
        before = _kernel_launches()
        codes = np.zeros(1, np.int8)
        qpad, params = self._single_qpad(codes)
        qdev = cuda_lib.to_device(qpad, self.device)
        parts = []
        for tiles, lens, kind in zip(self._bucket_tiles, self._bucket_lengths, self._kinds):
            parts.append(self._score_bucket(tiles, kind, codes, qdev, params, True, lengths=lens))
            if self.state16 and kind != "row":  # the row kernel is exact only
                self._score_bucket(tiles, kind, codes, qdev, params, False,
                                   lengths=lens).amax(dim=1)
            if kind == "col":
                self._warmup_col_chunked(tiles, lens)
        self._top_n(self._slots(parts))
        self._sync()
        n = _kernel_launches() - before
        if self.verbose:
            print(f"warmup: {n} kernel launches in {time.perf_counter() - t0:.1f}s")
        return n

    def _warmup_col_chunked(self, tiles, lengths) -> None:
        """Launch the col kernel on the carry variants that a query past
        NQC reaches on one bucket's tiles (``score_bucket_col_any_query``):
        take or emit the H/F carry (first, middle and last chunks) on the
        full and the remainder tile groups of ``sw_col.col_group_tiles``,
        each with the minimal query chunk and the tiles' ``lengths`` (the
        JAX engine's ``_warmup_col_chunked``)."""
        T, L = tiles.shape[0], tiles.shape[1]
        budget = cuda_lib.TEMP_BYTES if self.col_temp_bytes is None else self.col_temp_bytes
        tc = sw_col.col_group_tiles(T, L, sw_col.NQC, 2, budget)
        groups = [min(tc, T)] + ([T % tc] if tc < T and T % tc else [])
        qpad, nq_pad = sw_col.pad_query_chunk(np.zeros(1, np.int8), pad=self._pad)
        qdev = cuda_lib.to_device(qpad, self.device)
        params = (nq_pad, self.scoring.gop, self.scoring.gex, 0)
        for gt in groups:
            sub = tiles[:gt]
            zero = torch.zeros(sub.shape, dtype=torch.int32, device=self.device)
            for take, emit in ((False, True), (True, True), (True, False)):
                sw_col.score_bucket_col(sub, qdev, self._matrix_flat, params,
                                        state_in=(zero, zero) if take else None,
                                        take_init=take, emit_state=emit, lengths=lengths[:gt])

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
        the pad code to ``qcap``, or to the next multiple of ``qcap`` for a
        longer query (the kernels stop at nq, and the plain versions never
        walk padded rows), and params [nq, gop, gex, nq_pad], nq_pad rounded
        up to the col kernel's row granule."""
        cap = self.qcap
        qpad, nq = prepare_query(codes, qcap=max(cap, -(-len(codes) // cap) * cap), pad=self._pad)
        params = np.array(
            [nq, self.scoring.gop, self.scoring.gex, sw_col.padded_rows(nq)], dtype=np.int32
        )
        return qpad, params

    def _exact_for(self, codes) -> bool:
        """Whether a single scan of ``codes`` runs exact int32 state: always
        without ``state16``, and for queries longer than ``qcap`` (as the
        JAX engine's ``_scan_long_query``)."""
        return not self.state16 or len(codes) > self.qcap

    def _score_bucket(self, tiles, kind, codes, qdev, params, exact: bool, matrix=None,
                      lengths=None):
        """Scores f32 [T, NS] of one query against one bucket's tiles: col
        buckets take NQC-row chunks with the H/F carry when the query's
        padded rows pass NQC, every other case one kernel call.  A streamed
        pass caps the tile groups' temporaries at ``_temp_bytes``: the
        carry's groups at half of it, as its in and out carries live
        together.  ``matrix``: the substitution matrix on the tiles' device
        (default: the engine's); ``lengths``: the tiles' subject lengths
        (``sw_col.ColLengths``) for the col kernels, or None."""
        matrix = self._matrix_flat if matrix is None else matrix
        with span(f"sw:bucket {kind} L={tiles.shape[1]}", tiles.device):
            if kind == "col" and int(params[3]) > sw_col.NQC:
                temp = self.col_temp_bytes
                if self._temp_bytes is not None:
                    half = self._temp_bytes // 2
                    temp = half if temp is None else min(temp, half)
                return sw_col.score_bucket_col_any_query(
                    tiles, codes, matrix, self.scoring.gop, self.scoring.gex,
                    pad=self._pad, temp_bytes=temp, exact=exact, lengths=lengths,
                )
            return score_bucket(tiles, qdev, matrix, params, kind, exact=exact,
                                temp_bytes=self._temp_bytes, lengths=lengths)

    def bucket_scores(self, codes, exact: bool = True) -> list[torch.Tensor]:
        """Scores f32 [T, NS] of one query against each bucket, in bucket
        order, on the device; ``exact=False``: int16 state (cell and col
        buckets)."""
        if self.streaming or self.mesh is not None:
            raise RuntimeError("bucket scores need a database resident on one device; a "
                               "streamed one yields its scores chunk by chunk (_stream_rows)")
        return self._bucket_parts(self._bucket_tiles, self.device, codes, exact,
                                  lengths=self._bucket_lengths)

    def _bucket_parts(self, bucket_tiles, device, codes, exact: bool, matrix=None,
                      lengths=None) -> list:
        """Scores f32 [T, NS] of one query against each of ``bucket_tiles``
        on ``device`` (None where a shard holds no tile of the bucket), each
        bucket on its own kind, with its entry of ``lengths``
        (``_col_lengths``; None: none)."""
        codes = np.asarray(codes, dtype=np.int8)
        qpad, params = self._single_qpad(codes)
        qdev = cuda_lib.to_device(qpad, device)
        return [
            None if tiles is None
            else self._score_bucket(tiles, kind, codes, qdev, params, exact, matrix, lens)
            for tiles, lens, kind in zip(bucket_tiles, lengths or [None] * len(bucket_tiles),
                                         self._kinds)
        ]

    def slot_scores(self, codes, exact: bool = True) -> torch.Tensor:
        """Scores f32 of every slot of the packed database, in slot order
        (bucket, tile, lane), on the device; padding slots hold whatever
        the kernels gave them (mask with ``seq_index >= 0``)."""
        return self._slots(self.bucket_scores(codes, exact))

    def _slots(self, parts, device=None) -> torch.Tensor:
        """Per-bucket scores [T, NS] flattened into one slot-order vector
        (None parts skipped)."""
        parts = [p for p in parts if p is not None]
        if not parts:
            return torch.zeros(0, dtype=torch.float32, device=device or self.device)
        return torch.cat([p.reshape(-1) for p in parts])

    def _top_n(self, scores: torch.Tensor, ids: torch.Tensor | None = None):
        """Top ``max(1, results_per_query)`` slots of each row of ``scores``
        ([N] or [S, N]) by descending score, then ascending slot (=
        ascending reference id) (``sharding.top_n``).  ``ids``: int64 [N]
        reference id of each slot, -1 for padding (default: the resident
        database's).  Returns (scores, ids) on the scores' device; padding
        slots that make up a short row come out as (-1, -1)."""
        ids = self._flat_idx if ids is None else ids
        return sharding.top_n(scores, ids, self.results_per_query)

    def _dispatch(self, codes):
        """Launch one query's scan; returns device (scores, ids, tile
        maxima), the tile maxima [T] per bucket for an int16-state scan and
        None for an exact one; on a mesh, ``_dispatch_mesh``'s."""
        exact = self._exact_for(codes)
        with span("sw:enqueue", self.device):
            if self.mesh is not None:
                return self._dispatch_mesh(codes, exact)
            parts = self.bucket_scores(codes, exact)
            vals, ids = self._top_n(self._slots(parts))
            return vals, ids, None if exact else [p.amax(dim=1) for p in parts]

    def _dispatch_mesh(self, codes, exact: bool):
        """Enqueue one query on every local shard, each on its slice of
        every bucket, reduced to its top N with its tile maxima under int16
        state (the JAX package's ``build_sharded_scan``, chunked col
        buckets included); reads nothing back.  Returns (Candidates,
        exact, None), the arguments ``_finish_single`` takes."""
        cands = Candidates(self.mesh, self.results_per_query, 1)
        for sh in self._shards:
            with shard_span(sh):
                parts = self._bucket_parts(sh.tiles, sh.device, codes, exact, sh.matrix,
                                           sh.lengths)
                vals, ids = self._top_n(self._slots(parts, sh.device), sh.ids)
                tmax = () if exact else [torch.zeros(0) if p is None else p.amax(dim=1)
                                         for p in parts]
                cands.add(sh, vals, ids, tmax)
        return cands, exact, None

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
        at or above SAT.  Reads the device results back.  On a mesh
        (``_dispatch_mesh``'s (Candidates, exact) as ``vals, ids``), the
        shards' merge and ``_rescore_overflow_mesh``."""
        if self.mesh is not None:
            return self._finish_mesh(codes, vals, ids)
        vals, ids = vals.tolist(), ids.tolist()
        if tmaxes is None or not vals or vals[0] < sw_cell.SAT:
            return vals, ids, 0
        overflows = sum(1 for v in vals if v >= sw_cell.SAT)
        vals, ids = self._rescore_overflow(tmaxes, vals, ids, codes)
        return vals, ids, overflows

    def _finish_mesh(self, codes, cands: Candidates, exact: bool):
        """``_finish_single`` of a mesh launch: waits for the local shards'
        candidates, merges every shard's, and re-scores on the mesh when
        the top score reaches SAT."""
        host = cands.host()
        v, i = cands.merged(host)
        keep = i[0] >= 0
        vals, ids = v[0][keep].tolist(), i[0][keep].tolist()
        if exact or not vals or vals[0] < sw_cell.SAT:
            return vals, ids, 0
        overflows = sum(1 for x in vals if x >= sw_cell.SAT)
        vals, ids = self._rescore_overflow_mesh(host[2], vals, ids, codes)
        return vals, ids, overflows

    def _rescore_overflow(self, tmaxes, vals, ids, codes):
        """Exact int32 re-score of only the tiles whose int16 max reached
        SAT, merged into the fast pass's top-N by (-score, id) (the JAX
        engine's single-device ``_rescore_overflow``; on a mesh,
        ``_rescore_overflow_mesh``).

        A saturated subject's exact score is >= SAT and every unsaturated
        score is exact and < SAT, so the true top-N is the exact scores of
        the flagged tiles' subjects merged with the fast top-N less its
        entries from those tiles.  Returns host (vals, ids)."""
        sat = sw_cell.SAT
        qpad, params = self._single_qpad(codes)
        qdev = cuda_lib.to_device(qpad, self.device)
        cand_v, cand_i = [], []
        for b, tiles, lens, kind, tmax in zip(self.packed.buckets, self._bucket_tiles,
                                              self._bucket_lengths, self._kinds, tmaxes):
            sel = torch.nonzero(tmax >= sat).flatten()
            if sel.numel() == 0:
                continue
            host_sel = sel.cpu().numpy()
            s = self._score_bucket(tiles.index_select(0, sel), kind, codes, qdev, params, True,
                                   lengths=None if lens is None else lens.select(host_sel, sel))
            sidx = b.seq_index[host_sel].reshape(-1)
            s = s.reshape(-1).cpu().numpy()
            keep = sidx >= 0
            cand_v.append(s[keep].astype(np.int64))
            cand_i.append(sidx[keep].astype(np.int64))
        if not cand_v:  # a flag without a flagged tile cannot happen
            return vals, ids
        return _merge_rescored(vals, ids, np.concatenate(cand_v), np.concatenate(cand_i))

    def _rescore_overflow_mesh(self, tmaxes, vals, ids, codes):
        """The mesh twin of ``_rescore_overflow`` (the JAX engine's
        ``_rescore_overflow_mesh`` and ``build_sharded_overflow_rescore``):
        each shard re-scores its flagged tiles (``tmaxes``: per local shard,
        its tile maxima per bucket on the host) with exact state and
        reduces them to its top N; the shards' candidates merge with the
        fast top-N's entries below SAT that are not among them.  Every
        subject that saturated has an exact score >= SAT, above every fast
        entry kept, and a shard's top N holds all of its subjects that can
        reach the global top N.  When some shard flags more than
        OVF_TILE_CAP tiles of a bucket, the query is scanned again in exact
        state instead.  Returns host (vals, ids)."""
        sat = sw_cell.SAT
        need = np.array([[int((tm >= sat).sum()) for tm in per] for per in tmaxes], np.int64)
        if int(self.mesh.gather(need.reshape(len(tmaxes), -1)).max(initial=0)) > self.OVF_TILE_CAP:
            vals, ids, _ = self._finish_mesh(codes, *self._dispatch_mesh(codes, True)[:2])
            return vals, ids
        qpad, params = self._single_qpad(np.asarray(codes, np.int8))
        cands = Candidates(self.mesh, self.results_per_query, 1)
        for sh, per in zip(self._shards, tmaxes):
            with shard_span(sh):
                qdev = cuda_lib.to_device(qpad, sh.device)
                parts, idparts = [], [np.zeros(0, np.int64)]
                for bi, (tiles, lens, kind, tm) in enumerate(zip(sh.tiles, sh.lengths,
                                                                 self._kinds, per)):
                    sel = np.nonzero(tm >= sat)[0]
                    if sel.size == 0:
                        continue
                    sel_dev = cuda_lib.to_device(sel, sh.device)
                    parts.append(self._score_bucket(
                        tiles.index_select(0, sel_dev), kind, codes, qdev, params, True,
                        sh.matrix, None if lens is None else lens.select(sel, sel_dev)))
                    sidx = self.packed.buckets[bi].seq_index[sh.first[bi] + sel]
                    idparts.append(np.asarray(sidx, np.int64).reshape(-1))
                ids_dev = cuda_lib.to_device(np.concatenate(idparts), sh.device)
                cands.add(sh, *self._top_n(self._slots(parts, sh.device), ids_dev))
        cv, ci = cands.merged()
        ok = ci[0] >= 0
        return _merge_rescored(vals, ids, cv[0][ok], ci[0][ok])

    def _sync(self) -> None:
        devices = self.mesh.local_devices if self.mesh is not None else [self.device]
        for d in dict.fromkeys(devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _encode(self, sequence):
        if isinstance(sequence, (str, bytes)):
            return encode(sequence)
        return np.asarray(sequence, np.int8)

    def scan(self, sequence) -> ScanResult:
        """Search one query against the resident database."""
        if self.packed is None:
            raise RuntimeError("set_database() must be called before scan()")
        with span("sw:scan", self.device):
            codes = self._encode(sequence)
            if self.streaming:  # one pass of the streamed batch, exact state
                return self._scan_streaming_batch([codes])[0]
            t0 = time.perf_counter()
            out = self._dispatch(codes)
            with span("sw:finish", self.device):
                vals, ids, overflows = self._finish_single(codes, *out)
                self._sync()
                result = self._result(vals, ids, len(codes), time.perf_counter() - t0, overflows)
        if self.debug_check:
            self._debug_check_result(codes, result)
        return result

    def _seconds(self, t0: float) -> float:
        """Host seconds of a launch made at ``t0``, read once its result is
        on the host: from the later of its launch and the previous result's
        arrival to now, so that launches queued ahead share the wall time
        without counting it twice."""
        now = time.perf_counter()
        seconds = now - max(t0, self._host_done)
        self._host_done = now
        return seconds

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
        if self.streaming or self.mesh is not None:
            raise RuntimeError("batch slot scores need a database resident on one device")
        return self._batch_rows(self._bucket_tiles, self.device, group,
                                lengths=self._bucket_lengths)

    def _batch_rows(self, bucket_tiles, device, group, matrix=None,
                    lengths=None) -> torch.Tensor:
        """Scores f32 [len(group), slots] of a batch against ``bucket_tiles``
        on ``device`` (None entries skipped), in slot order, each bucket
        with its entry of ``lengths`` (``_col_lengths``; None: none)."""
        S = len(group)
        qcap_b = self._qcap_batch
        queries, nqs, pads, params = self._batch_slot_params(enumerate(group), S, qcap_b)
        plan = ()
        if any(k == "col" for k in self._kinds):
            plan = col_flat_plan(pads, limit=S, rtot=qcap_b)
        batch = (cuda_lib.to_device(queries, device), nqs, pads, params, plan)
        parts = [self._batch_bucket(tiles, kind, *batch, matrix=matrix, lengths=lens)
                 for tiles, lens, kind in zip(bucket_tiles, lengths or [None] * len(bucket_tiles),
                                              self._kinds)
                 if tiles is not None]
        if not parts:
            return torch.zeros((S, 0), dtype=torch.float32, device=device)
        return torch.cat(parts, dim=1)

    def _batch_bucket(self, tiles, kind, qdev, nqs, pads, params, plan,
                      matrix=None, lengths=None) -> torch.Tensor:
        """Scores f32 [S, T x NS] of a batch's S slots (``_batch_slot_params``
        layout, queries ``qdev`` on the device, ``plan`` from col_flat_plan
        on a database with col buckets) against one bucket's tiles: the
        cell batch kernel on cell tiles, one flat-pool launch per plan pass
        on col tiles, the row kernel per slot on row tiles.  ``matrix``: on
        the tiles' device (default: the engine's); ``lengths``: the tiles'
        subject lengths for the col kernels, or None."""
        with span(f"sw:batch_bucket {kind} L={tiles.shape[1]}", tiles.device):
            S = qdev.shape[0]
            matrix = self._matrix_flat if matrix is None else matrix
            if kind == "cell":
                s = sw_cell.score_bucket_cell_batch(tiles, qdev, matrix, params)
            elif kind == "col":
                got = [None] * S
                for s_part, slots in batch_col_scores(
                    tiles, qdev, matrix, params, S, plan, rtot=self._qcap_batch,
                    temp_bytes=self._temp_bytes, lengths=lengths,
                ):
                    for si, slot in enumerate(slots):
                        got[slot] = s_part[si]
                s = torch.stack(got)
            else:
                gop, gex = self.scoring.gop, self.scoring.gex
                s = torch.stack([
                    score_bucket(tiles, qdev[i], matrix, (int(nqs[i]), gop, gex, int(pads[i])), kind)
                    for i in range(S)
                ])
            return s.reshape(S, -1)

    def _dispatch_batch(self, group):
        """Launch one batch; returns device (scores, ids), each [S, k]
        (batches are exact); on a mesh, (Candidates, None)."""
        with span("sw:scan_batch", self.device):
            if self.mesh is None:
                return self._top_n(self.batch_slot_scores(group))
            return self._dispatch_batch_mesh(group), None

    def _dispatch_batch_mesh(self, group) -> Candidates:
        """Enqueue one batch on every local shard (the JAX package's
        ``build_sharded_batch_scan``: B4, B5 or B6, and B2 on each shard's
        slices) and reduce each shard's rows to its top N."""
        cands = Candidates(self.mesh, self.results_per_query, len(group))
        for sh in self._shards:
            with shard_span(sh):
                rows = self._batch_rows(sh.tiles, sh.device, group, sh.matrix, sh.lengths)
                cands.add(sh, *self._top_n(rows, sh.ids))
        return cands

    def _materialize_batch(self, vals, ids, group, t0: float) -> list[ScanResult]:
        """Per-query ScanResults of one batch launched at ``t0``, in order.
        A query's seconds are the batch's (``_seconds``) split in proportion
        to its cells (queries are not separately observable inside one
        batch).  On a mesh ``vals`` is the batch's Candidates, merged here."""
        with span("sw:finish", self.device):
            if isinstance(vals, Candidates):
                vals, ids = vals.merged()
            vals, ids = vals.tolist(), ids.tolist()  # waits for the batch
            seconds = self._seconds(t0)
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
        t0 = time.perf_counter()
        vals, ids = self._dispatch_batch(group)
        return self._materialize_batch(vals, ids, group, t0)

    def scan_many(self, sequences, window: int = 3):
        """Pipelined scans: yields one ScanResult per input sequence, in
        order.  Queries of at most ``_qcap_batch`` residues are grouped into
        batches of up to QB_MAX; a group is launched when it is full or a
        longer query arrives, which then runs alone.  Under ``state16``
        every query runs alone (the batch kernels are exact), as in the JAX
        engine.  Up to ``window`` launches (batches or singles) are queued
        ahead of reading their results back, so the host's work overlaps
        the device's.  A single's seconds run on the host from the later of
        its launch and the previous result's arrival to its result on the
        host, its overflow re-score included; a batch's are split over its
        queries by their cells (``_seconds``).  A streamed
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
        pending: deque = deque()  # (group or None, (vals, ids, tmaxes), codes, launch time)
        shortbuf: list = []
        qcap_b = self._qcap_batch if not self.state16 else -1

        def materialize(entry):
            group, out, codes, t0 = entry
            if group is not None:
                return self._materialize_batch(*out, group, t0)
            with span("sw:finish", self.device):
                vals, ids, overflows = self._finish_single(codes, *out)
                result = self._result(vals, ids, len(codes), self._seconds(t0), overflows)
            if self.debug_check:
                self._debug_check_result(codes, result)
            return [result]

        def flush_shorts():
            if shortbuf:
                group = list(shortbuf)
                shortbuf.clear()
                t0 = time.perf_counter()
                pending.append((group, self._dispatch_batch(group), None, t0))

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
            t0 = time.perf_counter()
            pending.append((None, self._dispatch(codes), codes, t0))
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
