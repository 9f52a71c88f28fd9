"""Streaming scans: databases larger than the device budget (the port's
counterpart of the single-device path of cudasw4_tpu/engine_streaming.py).

The mixin half of SearchEngine (engine.py) that holds the host->device
pipeline:

- chunks of ct tiles of each bucket (``chunk_tiles``: capped by
  ``stream_chunk_bytes`` and ``max_batch_sequences``, the reference's
  copy plan, cudasw4.cuh:1177-1277), a bucket's last chunk shorter;
- the working memory of a pass (``stream_work_bytes``): the staging ring,
  the chunks being unpacked and scored, the scores and top-N keys of a
  chunk, and one tile group's kernel temporaries, whose cap every kernel
  of the pass keeps.  A database streams when its tiles and that working
  memory exceed the budget, as the reference sizes its working set before
  it places the database (allocateGpuWorkingSets, cudasw4.cuh:1006);
- the resident prefix: as many whole chunks as the budget less the
  working memory allows stay on the device (``_load_resident_prefix``,
  the reference's assignBatchesToGpuMem, cudasw4.cuh:1087-1144), and
  only the rest streams;
- the transfer codec (ops/pack5.py): streamed chunks travel as b32 or b21
  words from the ``<pack_cache>.pack5/`` sidecar and unpack on the device
  (``_build_stream_pack``, ``_put_chunk``);
- the copy pipeline (``_StagingRing``, ``_scan_chunks``): each chunk is
  read from the disk-backed store into one of ``depth`` page-locked
  buffers and copied on a copy stream into the matching device buffer
  while the card still runs the kernels enqueued for the chunk before;
  CUDA events order the copy stream and the compute stream both ways;
- the streamed batch (``_scan_streaming_batch``): up to QB_STREAM queries
  of any length share one pass over the database.

Per chunk, the port's own kernels run through the engine's wrappers:
queries of at most ``_qcap_batch`` residues as one batch (B4 on cell
chunks, ``col_flat_plan`` passes of B5, or B6 under COL_FUSE_MIN_S, on
col chunks, B2 a query on row chunks); longer ones one by one
(``_score_bucket``: B1, B3 with the H/F carry, B2).  Each chunk's top N
per query is taken on the device under the engine's tie rule (a few
small kernels, no read-back); the candidates of every chunk come back in
one copy at the end of the pass, so the thread that enqueues the kernels
never waits for the card mid-pass, and the host merges them by
``np.lexsort((ids, -scores))``.  Streamed scans
always run exact int32 state, as the JAX package's do, and batch under
``state16`` too.  A query's seconds are the streamed batch's wall time
(from its start to the last chunk's results on the host, the transfers
included, since the user waits for them) split by each query's cells.

The pass's spans (``utils.profiling.span``, under ``sw:stream_pass``),
for each chunk: ``sw:stream_wait`` (the host waiting for the staging
slot's previous copy), ``sw:stream_read`` (the chunk's read into
page-locked memory, the interval that ``stream_copy_stats()
["host_copy_ms"]`` sums), ``sw:unpack`` (``_put_chunk``), the engine's
``sw:batch_bucket``/``sw:bucket`` spans of its kernels and ``sw:top_n``;
a resident prefix chunk has only the last two.  Then ``sw:readback``
around the candidates' one copy to the host, and after the pass
``sw:finish`` around the merge and the results.  No span stays open while
the chunk generators yield.

On a mesh (parallel/sharding.py) a chunk's tiles are a multiple of the
mesh size and split over the shards as a resident bucket's do
(``sharding.shard_ranges``): each shard stages its rows through a ring of
its own on its device, unpacks and scores them there (in ``sw:shard
<pos>``), and keeps its top N of the chunk; the last chunk of a bucket
splits at its real size, in slices of ceil(t / ndev) tiles, where the JAX
package pads it to the full chunk.  At the end of the pass each shard's candidates come back, reduce
to its top N, and merge across shards and processes.  Budgets are per
shard: a shard's tiles, prefix and working memory against one shard's
budget.  A mesh across processes packs only the tiles its shards read
(``_host_tile_ranges``, the per-host tile store).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from .ops import col_flat_plan, cuda_lib, sw_cell, sw_col, sw_row
from .parallel.sharding import Candidates, shard_context, shard_ranges, shard_span
from .utils.profiling import span

#: Environment switch of the resident prefix ("1" on, anything else off).
STREAM_RESIDENT_ENV = "CUDASW4_TPU_TORCH_STREAM_RESIDENT"

#: Queries per streamed pass, of any length: every pass sends the
#: streamed part of the database across the link again, so a larger batch
#: divides that transfer (the reference's set is 20 queries: one pass).
QB_STREAM = 20

#: Default cap of a streamed chunk's tile bytes (--maxBatchBytes).
STREAM_CHUNK_BYTES = 256 << 20

#: Staging slots of a pass: a chunk is read and copied while the card
#: scores the one before.
STAGING_DEPTH = 2

#: Device bytes a subject slot of a chunk holds for each query of a pass
#: while the chunk's top N is taken: the kernels' f32 scores, their
#: stacked copy, and three int64 sort keys of ``_top_n``.
SLOT_BYTES_PER_QUERY = 4 + 4 + 3 * 8

#: Query blocks, the substitution matrix and the chunks' top-N candidates.
SMALL_BYTES = 4 << 20


def batch_rows(kinds) -> int:
    """Longest query a batch takes on buckets of these kinds: QCAP_BATCH,
    or NQC when there are col buckets, whose batch passes pack the slots'
    rows into a pool of NQC rows (longer queries run as singles)."""
    if "col" not in kinds:
        return sw_cell.QCAP_BATCH
    return min(sw_cell.QCAP_BATCH, sw_col.NQC)


def chunk_tiles(L: int, NS: int, T: int, chunk_bytes: int, max_seqs: int | None,
                ndev: int = 1) -> int:
    """Tiles of a streamed chunk of a bucket of T tiles [L, NS]: as many as
    ``chunk_bytes`` holds (--maxBatchBytes), and no more subject slots
    than ``max_seqs`` (--maxBatchSequences), whichever binds first, at
    least one tile, at most the bucket's; on a mesh of ``ndev`` shards a
    multiple of ndev (at least ndev, at most T rounded up to ndev)."""
    ct = max(1, chunk_bytes // (L * NS))
    if max_seqs is not None:
        ct = min(ct, max(1, max_seqs // NS))
    ct = max(ndev, ct // ndev * ndev)
    return min(ct, -(-T // ndev) * ndev)


def one_tile_temp_bytes(L: int, NS: int, kind: str, rows: int) -> int:
    """Device temporaries of one tile of a bucket under the kernels that a
    streamed pass runs on it, ``rows`` the batch's pool rows: on col tiles
    the larger of B5/B6's boundary columns at the full pool and B3's
    carry in and out (H and F, 8 bytes a tile char each) with its
    boundary columns at NQC rows; on row tiles past the cell route B2's
    boundary columns at NQC rows (a longer query's grow with it, 8 x NS
    bytes a row); none on cell tiles."""
    if kind == "col":
        return max(cuda_lib.col_boundary_bytes(1, rows),
                   16 * L * NS + cuda_lib.col_boundary_bytes(1, sw_col.NQC))
    if kind == "row" and sw_row.row_route(1, L, NS, sw_col.NQC)[0] == "col":
        return cuda_lib.col_boundary_bytes(1, sw_col.NQC, ns=NS)
    return 0


def stream_work_bytes(shapes, chunk_bytes: int = STREAM_CHUNK_BYTES,
                      max_seqs: int | None = None, queries: int = QB_STREAM,
                      ndev: int = 1) -> tuple[int, int]:
    """(work, temp): the device bytes a streamed pass of ``queries``
    queries takes besides its resident prefix, over buckets of ``shapes``
    = (L, NS, kind, T), on each shard of a mesh of ``ndev`` (whose chunks
    split in ndev slices), and ``temp``, the cap of one tile group's kernel
    temporaries (the largest ``one_tile_temp_bytes``), which is part of
    the work.  The rest, for the largest chunk slice: the staging ring's device
    buffers (``STAGING_DEPTH`` chunks and their seq_index), four chunks of
    tiles (the one scored, the next one unpacked, and the unpack's
    temporaries: two int32 digit planes of at most 4/6 bytes a residue,
    or a contiguous copy), ``SLOT_BYTES_PER_QUERY`` a subject slot and
    query and 8 a slot for its ids, and ``SMALL_BYTES``."""
    shapes = [s for s in shapes if s[3]]
    if not shapes:
        return SMALL_BYTES, 0
    rows = batch_rows({s[2] for s in shapes})
    temp = max(one_tile_temp_bytes(L, NS, kind, rows) for L, NS, kind, _ in shapes)
    tiles = slots = 0
    for L, NS, _, T in shapes:
        ct = chunk_tiles(L, NS, T, chunk_bytes, max_seqs, ndev) // ndev
        tiles, slots = max(tiles, ct * L * NS), max(slots, ct * NS)
    ring = STAGING_DEPTH * (tiles + 4 * slots)
    work = ring + 4 * tiles + slots * (SLOT_BYTES_PER_QUERY * queries + 8) + SMALL_BYTES + temp
    return work, temp


def streams(shapes, budget: int, chunk_bytes: int = STREAM_CHUNK_BYTES,
            max_seqs: int | None = None, queries: int = QB_STREAM, ndev: int = 1) -> bool:
    """Whether a database of buckets ``shapes`` = (L, NS, kind, T) streams
    under ``budget``: its tiles and a streamed pass's working memory
    exceed it (on a mesh of ``ndev`` shards, the largest shard's tiles,
    ceil(T / ndev) of each bucket, and one shard's working memory against
    one shard's budget)."""
    padded = sum(L * NS * -(-T // ndev) for L, NS, _, T in shapes)
    return padded + stream_work_bytes(shapes, chunk_bytes, max_seqs, queries, ndev)[0] > budget


def host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor of ``arr``'s values: shares a writable array, copies a
    read-only one (a store's memmap)."""
    return torch.from_numpy(arr if arr.flags.writeable else np.array(arr))


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """``arr`` on ``device``, copied from pageable memory (a one-time
    upload: page-locking a database-sized buffer would hold that much host
    memory)."""
    return host_tensor(arr).to(device)


class _StagingRing:
    """``depth`` staging slots between the host and the card, for one scan
    pass, used in turn.  A slot is a page-locked host buffer and a device
    buffer, each of the largest streamed chunk's bytes (packed words or
    raw tiles) and its seq_index, an event ``copied`` recorded on the copy
    stream after the slot's copy, and an event ``consumed`` recorded on
    the compute stream after the last work that reads the slot's device
    buffers.

    - ``stage`` waits on the host for the slot's previous copy before
      refilling its page-locked buffer, makes the copy stream wait for
      ``consumed`` before overwriting its device buffer, enqueues the
      copy and records ``copied``;
    - ``take`` makes the compute stream wait for ``copied`` and returns
      views of the device buffers;
    - ``release``, once every kernel that reads the chunk is enqueued,
      records ``consumed``.  The caller releases a chunk before it stages
      the chunk ``depth`` places later, so the copy stream's wait always
      sees that record.

    On the CPU a chunk is a plain copy and the ring holds nothing.  ``log``
    (a list the rings of a mesh's shards share) holds (bytes, start event,
    ``copied``, host seconds) of each chunk: the events around its copy on
    CUDA, and the seconds of its read into the page-locked buffer (of the
    plain copy on the CPU).  ``stage`` emits the spans ``sw:stream_wait``
    and ``sw:stream_read`` on both.  The compute stream is the current one
    when the ring is made (a shard's, under its ``shard_context``).
    """

    def __init__(self, device, depth: int, payload_bytes: int, sidx_ints: int, log=None):
        self.device = device
        self.cuda = device.type == "cuda"
        self.log: list = [] if log is None else log
        if not self.cuda:
            return
        self.depth = depth
        self.turn = 0
        self.copy_stream = torch.cuda.Stream(device)
        self.compute_stream = torch.cuda.current_stream(device)
        self.host = [(torch.empty(payload_bytes, dtype=torch.uint8, pin_memory=True),
                      torch.empty(sidx_ints, dtype=torch.int32, pin_memory=True))
                     for _ in range(depth)]
        self.dev = [(torch.empty(payload_bytes, dtype=torch.uint8, device=device),
                     torch.empty(sidx_ints, dtype=torch.int32, device=device))
                    for _ in range(depth)]
        for pair in self.dev:  # the copy stream writes them: the allocator waits for it
            for t in pair:
                t.record_stream(self.copy_stream)
        # The device buffers may reuse memory that kernels enqueued before
        # still read: the copy stream starts after them.
        self.copy_stream.wait_stream(self.compute_stream)
        self.copied: list = [None] * depth
        self.consumed = [torch.cuda.Event() for _ in range(depth)]

    def stage(self, chunk: np.ndarray, sidx: np.ndarray):
        """Start the host->device transfer of one chunk into the next slot;
        returns the item that ``take`` turns into device tensors."""
        if not self.cuda:
            with span("sw:stream_wait", self.device):
                pass  # a plain copy waits for nothing
            with span("sw:stream_read", self.device):
                t0 = time.perf_counter()
                item = host_tensor(np.array(chunk)), host_tensor(np.array(sidx))
                host_s = time.perf_counter() - t0
            self.log.append((chunk.nbytes + sidx.nbytes, None, None, host_s))
            return item
        slot, self.turn = self.turn, (self.turn + 1) % self.depth
        with span("sw:stream_wait", self.device):
            if self.copied[slot] is not None:
                self.copied[slot].synchronize()  # the page-locked buffer is read no more
        src = np.ascontiguousarray(chunk).reshape(-1).view(np.uint8)
        ids = np.ascontiguousarray(sidx, dtype=np.int32).reshape(-1)
        (hbuf, hidx), (dbuf, didx) = self.host[slot], self.dev[slot]
        with span("sw:stream_read", self.device):
            t0 = time.perf_counter()
            np.copyto(hbuf.numpy()[: src.size], src)  # the store's pages are read here
            np.copyto(hidx.numpy()[: ids.size], ids)
            host_s = time.perf_counter() - t0
        start, done = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.copy_stream):
            self.copy_stream.wait_event(self.consumed[slot])
            start.record(self.copy_stream)
            dbuf[: src.size].copy_(hbuf[: src.size], non_blocking=True)
            didx[: ids.size].copy_(hidx[: ids.size], non_blocking=True)
            done.record(self.copy_stream)
        self.copied[slot] = done
        self.log.append((src.size + ids.nbytes, start, done, host_s))
        return slot, chunk.shape, chunk.dtype, sidx.shape

    def take(self, item):
        """Device tensors (chunk, seq_index) of a staged item."""
        if not self.cuda:
            return item
        slot, shape, dtype, sshape = item
        self.compute_stream.wait_event(self.copied[slot])
        dbuf, didx = self.dev[slot]
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        chunk = dbuf[:n].view(torch.from_numpy(np.empty(0, dtype)).dtype).view(shape)
        return chunk, didx[: int(np.prod(sshape))].view(sshape)

    def release(self, item) -> None:
        if self.cuda:
            self.consumed[item[0]].record(self.compute_stream)


class StreamingEngineMixin:
    """Streaming scan methods of SearchEngine (see the module docstring)."""

    def _chunk_tiles(self, b) -> int:
        """Tiles of bucket ``b``'s streamed chunks (``chunk_tiles``)."""
        return chunk_tiles(b.L, b.NS, b.num_tiles, self.stream_chunk_bytes,
                           self.max_batch_sequences, self._mesh_ndev())

    def _stream_work(self, shapes) -> tuple[int, int]:
        """(work, temp) of ``stream_work_bytes`` for this engine's chunk
        caps, QB_STREAM queries and mesh."""
        return stream_work_bytes(shapes, self.stream_chunk_bytes, self.max_batch_sequences,
                                 self.QB_STREAM, self._mesh_ndev())

    def _host_tile_ranges(self, plans):
        """Per bucket of ``plans`` (``db.packing.plan_buckets``), the tile
        ranges this process's shards read on a streamed mesh: each chunk's
        slices at this process's positions (the resident prefix is whole
        chunks, split alike).  None when this process holds every shard.
        ``pack_db_to_store(tile_ranges=...)`` then packs only these (the
        per-host store, the JAX engine's ``_host_tile_ranges``)."""
        from .db.packing import _norm_ranges

        mesh = self.mesh
        if mesh is None or not mesh.multiprocess:
            return None
        out = []
        for start, stop, L, NS, _ in plans:
            T = -(-(stop - start) // NS)
            ct = chunk_tiles(L, NS, T, self.stream_chunk_bytes, self.max_batch_sequences,
                             mesh.size)
            rs = []
            for t0 in range(0, T, ct):
                split = shard_ranges(min(ct, T - t0), mesh.size)
                rs += [(t0 + split[p][0], t0 + split[p][1]) for p in mesh.local]
            out.append(_norm_ranges(rs, T))
        return out

    def _prefix_budget(self) -> int:
        """Device bytes the resident prefix (tiles and seq_index) may take:
        the budget less a pass's working memory, and at most 85% of it."""
        total = self._device_budget()
        return min(total - self._work_bytes, int(0.85 * total))

    def _load_resident_prefix(self) -> None:
        """Keep whole leading chunks of each bucket on the device, in bucket
        order, while they fit ``_prefix_budget`` (a bucket's partial last
        chunk always streams); the rest streams on every pass.  On a mesh
        each local shard keeps its slice of those chunks, within its own
        budget.  An entry is (bucket index, tiles, seq_index, subject
        lengths of a col chunk or None) on the device, or on a mesh
        (bucket index, [(tiles, seq_index, lengths) a shard]); the lengths
        are views of the bucket's resident ones (``_chunk_lengths``).
        Pinned only where the budget is known: an explicit
        ``max_device_bytes`` or a CUDA device (on a mesh across processes,
        only the explicit one, which every process shares).  The first
        ``torch.cuda.OutOfMemoryError`` ends the prefix there, as a device
        allocation failure does in the JAX package (a mesh across
        processes raises instead: its processes would disagree).
        ``CUDASW4_TPU_TORCH_STREAM_RESIDENT=0`` streams it all."""
        self._resident_chunks = []
        self._res_tiles = {}
        if os.environ.get(STREAM_RESIDENT_ENV, "1") != "1":
            return
        if self.max_device_bytes is None and (
            self.device.type != "cuda" or (self.mesh is not None and self.mesh.multiprocess)
        ):
            return  # unknown or unshared memory: do not pin blind
        budget = self._prefix_budget()
        if budget <= 0:
            return
        ndev = self._mesh_ndev()
        used, oom = 0, False
        for bi, b in enumerate(self.packed.buckets):
            if b.num_tiles == 0 or oom:
                continue
            ct = self._chunk_tiles(b)
            chunk_bytes = ct // ndev * b.NS * (b.L + 4)
            taken = 0
            for t0 in range(0, b.num_tiles, ct):
                t1 = min(t0 + ct, b.num_tiles)
                if t1 - t0 < ct or used + chunk_bytes > budget:
                    break
                try:
                    if self.mesh is None:
                        entry = (bi, upload(np.ascontiguousarray(b.tiles[t0:t1]), self.device),
                                 upload(np.ascontiguousarray(b.seq_index[t0:t1]), self.device),
                                 self._chunk_lengths(self._bucket_lengths[bi], t0, t1 - t0))
                    else:
                        entry = (bi, [self._upload_slice(sh, bi, t0, t1) for sh in self._shards])
                except torch.cuda.OutOfMemoryError:
                    if self.mesh is not None and self.mesh.multiprocess:
                        raise
                    oom = True
                    break
                self._resident_chunks.append(entry)
                used += chunk_bytes
                taken = t1
            if taken:
                self._res_tiles[bi] = taken
        self._prefix_bytes = used
        if self.verbose and used:
            total = float(self.packed.total_padded_chars)
            print(
                f"Resident prefix: {used / 2**30:.2f} GiB pinned on each device "
                f"({100.0 * used * ndev / total:.0f}% of the DB); remainder streams"
                + (" [stopped early: device allocation failed]" if oom else "")
            )

    def _upload_slice(self, shard, bi: int, t0: int, t1: int):
        """A shard's slice of the chunk [t0, t1) of bucket ``bi``: its tiles
        and seq_index on its device, and the view of its subject lengths."""
        b = self.packed.buckets[bi]
        a, e = shard_ranges(t1 - t0, self.mesh.size)[shard.pos]
        with shard_context(shard):
            return (upload(np.ascontiguousarray(b.tiles[t0 + a : t0 + e]), shard.device),
                    upload(np.ascontiguousarray(b.seq_index[t0 + a : t0 + e]), shard.device),
                    self._chunk_lengths(shard.stream_lengths[bi], t0, t1 - t0, shard))

    def _build_stream_pack(self, pack_cache: str | None):
        """Pack every bucket's tiles for the transfer (codec
        ``self._stream_codec``, ops/pack5.py) into disk-backed memmaps: the
        ``<pack_cache>.pack5/`` sidecar when a cache path is given (reused
        while its manifest matches and its ranges cover a per-host store's,
        rebuilt otherwise; an unwritable one falls back), else anonymous
        temp files, which skip the resident prefix.  Returns the packed
        int32 [T, W] memmap of each bucket."""
        import json
        import tempfile

        from .db.packing import _drop_manifest, _packed_layout, stream_manifest, stream_sidecar_fresh
        from .ops import pack5 as p5

        codec = self._stream_codec
        cpw, words_for, pack, _u, _un, maxc = p5.CODECS[codec]
        if int(self._pad) > maxc:
            raise ValueError(f"pad code {self._pad} exceeds codec {codec}")
        # A per-host store backs a sidecar of its own ranges, which are all
        # that this process streams.
        own = self.packed.tile_ranges
        expect = stream_manifest(
            codec, int(self._pad), self.packed.num_sequences, self.packed.total_real_chars,
            _packed_layout(self.packed), ranges=own,
        )
        sidecar = pack_cache + ".pack5" if pack_cache else None
        fresh = False
        if sidecar:
            fresh = stream_sidecar_fresh(pack_cache, expect, need_ranges=own)
            if not fresh:
                try:
                    _drop_manifest(sidecar)
                except OSError:
                    pass
        entries = []
        for bi, b in enumerate(self.packed.buckets):
            tile_shape = b.tiles.shape[1:]
            W = words_for(int(np.prod(tile_shape)))
            T = b.num_tiles
            if T == 0:
                entries.append(np.empty((0, W), np.int32))
                continue
            mm, persistent = None, False
            if sidecar:
                try:
                    path = os.path.join(sidecar, f"b{bi}.bin")
                    if fresh:
                        entries.append(np.memmap(path, np.int32, mode="r", shape=(T, W)))
                        continue
                    os.makedirs(sidecar, exist_ok=True)
                    mm = np.memmap(path, np.int32, mode="w+", shape=(T, W))
                    persistent = True
                except (OSError, ValueError):  # read-only or truncated: temp files
                    sidecar, mm = None, None
            if mm is None:
                f = tempfile.TemporaryFile(prefix=f"cudasw4_pack5_b{bi}_")
                f.truncate(T * W * 4)
                mm = np.memmap(f, np.int32, mode="w+", shape=(T, W))
            # A sidecar outlives this engine and packs every tile; a temp
            # pack skips the resident prefix, which never streams.
            start = 0 if persistent else self._res_tiles.get(bi, 0)
            if start < T:
                pack(b.tiles[start:], out=mm[start:])
            entries.append(mm)
        if sidecar and not fresh:
            try:
                with open(os.path.join(sidecar, "manifest.json"), "w") as f:
                    json.dump(expect, f)
            except OSError:
                pass
        if self.verbose:
            total = sum(mm.nbytes for mm in entries)
            bits = 32.0 / cpw
            print(
                f"Streaming transfer pack: {codec} tiles ({bits:.2f} bits/char), "
                f"{total / 2**20:.0f} MiB per full stream ({8.0 / bits:.2f}x under raw)"
            )
        return entries

    def _put_chunk(self, chunk: torch.Tensor, tile_shape) -> torch.Tensor:
        """The int8 tiles of a chunk on the device: packed words (int32)
        unpack there with the stream codec, tiles pass as they are."""
        with span("sw:unpack", chunk.device):
            if chunk.dtype == torch.int32:
                from .ops.pack5 import CODECS

                return CODECS[self._stream_codec][3](chunk, tuple(tile_shape))
            return chunk

    def _stream_chunks(self):
        """Yield (bucket index, first tile, chunk, seq_index) of every
        streamed chunk, past each bucket's resident prefix, the last two
        host arrays: tiles [ct, ...] int8, or
        packed words [ct, W] int32 with a stream codec.  A bucket's last
        chunk keeps its real tile count: the kernels take any count, and
        the JAX package's padding of it to ct tiles (one compiled program
        a shape) would add work that scores nothing."""
        for bi, b in enumerate(self.packed.buckets):
            ct = self._chunk_tiles(b)
            src = self._stream_pack[bi] if self._stream_pack is not None else b.tiles
            for t0 in range(self._res_tiles.get(bi, 0), b.num_tiles, ct):
                yield bi, t0, src[t0 : t0 + ct], b.seq_index[t0 : t0 + ct]

    def _staging_sizes(self) -> tuple[int, int]:
        """(payload bytes, seq_index entries) of the largest streamed chunk
        (of a shard's slice of it, on a mesh)."""
        payload = ints = 0
        for bi, b in enumerate(self.packed.buckets):
            if self._res_tiles.get(bi, 0) >= b.num_tiles:
                continue
            ct = -(-self._chunk_tiles(b) // self._mesh_ndev())
            per_tile = (self._stream_pack[bi].shape[1] * 4 if self._stream_pack is not None
                        else b.L * b.NS)
            payload, ints = max(payload, ct * per_tile), max(ints, ct * b.NS)
        return payload, ints

    def _chunk_lengths(self, lengths, t0: int, n: int, shard=None):
        """The view of ``lengths`` (a bucket's ``sw_col.ColLengths``, or
        None) for its chunk of tiles [t0, t0 + n), or for ``shard``'s slice
        of that chunk (``shard_ranges``)."""
        if lengths is None:
            return None
        if shard is not None:
            a, e = shard_ranges(n, self.mesh.size)[shard.pos]
            t0, n = t0 + a, e - a
        return lengths[t0 : t0 + n]

    def _scan_chunks(self, depth: int = STAGING_DEPTH):
        """Every chunk of one pass as (bucket, int8 tiles, seq_index,
        subject lengths of a col chunk or None) on the device: the resident
        prefix first, then the streamed rest through a ``_StagingRing`` of
        ``depth`` slots (the reference's pinned double buffers,
        cudasw4.cuh:1649-1707), made before the prefix is scored.  A chunk
        is staged after the kernels of the chunk before are enqueued, so
        that its read from the store and its copy overlap them on the
        card.  A chunk's lengths are a view of the bucket's resident ones."""
        ring = _StagingRing(self.device, depth, *self._staging_sizes())
        self._stream_log = ring.log
        for bi, xdev, sdev, lens in self._resident_chunks:
            yield self.packed.buckets[bi], xdev, sdev, lens
        for bi, t0, chunk, sidx in self._stream_chunks():
            b = self.packed.buckets[bi]
            lens = self._chunk_lengths(self._bucket_lengths[bi], t0, len(chunk))
            item = ring.stage(chunk, sidx)
            tiles, ids = ring.take(item)
            yield b, self._put_chunk(tiles, b.tiles.shape[1:]), ids, lens
            ring.release(item)

    def _scan_chunks_mesh(self, depth: int = STAGING_DEPTH):
        """``_scan_chunks`` on a mesh: every chunk of one pass as (bucket,
        [(int8 tiles, seq_index, subject lengths of a col chunk or None) on
        the shard's device, or None where its slice is empty] a local
        shard).  Each shard stages its slice
        (``shard_ranges`` of the chunk) through a ring of its own, on its
        stream; a chunk's slices are released after the caller has
        enqueued their kernels."""
        self._stream_log = []
        rings = []
        for sh in self._shards:
            with shard_context(sh):
                rings.append(_StagingRing(sh.device, depth, *self._staging_sizes(),
                                          log=self._stream_log))
        for bi, per_shard in self._resident_chunks:
            yield self.packed.buckets[bi], per_shard
        for bi, t0, chunk, sidx in self._stream_chunks():
            b = self.packed.buckets[bi]
            split = shard_ranges(len(chunk), self.mesh.size)
            parts, items = [], []
            for sh, ring in zip(self._shards, rings):
                a, e = split[sh.pos]
                item = part = None
                if e > a:
                    with shard_context(sh):
                        item = ring.stage(chunk[a:e], sidx[a:e])
                        tiles, ids = ring.take(item)
                        part = (self._put_chunk(tiles, b.tiles.shape[1:]), ids,
                                self._chunk_lengths(sh.stream_lengths[bi], t0, len(chunk), sh))
                parts.append(part)
                items.append(item)
            yield b, parts
            for sh, ring, item in zip(self._shards, rings, items):
                if item is not None:
                    with shard_context(sh):
                        ring.release(item)

    def stream_copy_stats(self) -> dict:
        """The last pass's streamed chunks, bytes, the host's milliseconds
        reading them into page-locked memory and, on CUDA, the copy
        stream's busy milliseconds (events around each copy; waits for
        them)."""
        log = getattr(self, "_stream_log", [])
        ms = None
        if log and log[0][1] is not None:
            ms = sum(a.elapsed_time(b) for _, a, b, _ in log)
        return {"chunks": len(log), "bytes": sum(e[0] for e in log), "copy_ms": ms,
                "host_copy_ms": 1e3 * sum(e[3] for e in log)}

    def _stream_setup(self, group, device):
        """The device side of a streamed pass of encoded queries ``group`` on
        ``device``: (shorts, longs, batch, singles).  Queries of at most
        ``_qcap_batch`` residues (``shorts``) share the batch kernels, their
        layout in ``batch``; each longer one (``longs``) has its query
        block and params in ``singles``."""
        qcap_b = self._qcap_batch
        shorts = [i for i, c in enumerate(group) if len(c) <= qcap_b]
        longs = [i for i, c in enumerate(group) if len(c) > qcap_b]
        batch = None
        if shorts:
            queries, nqs, pads, params = self._batch_slot_params(
                ((slot, group[i]) for slot, i in enumerate(shorts)), len(shorts), qcap_b
            )
            plan = ()
            if any(b.kernel == "col" for b in self.packed.buckets):
                plan = col_flat_plan(pads, limit=len(shorts), rtot=qcap_b)
            batch = (cuda_lib.to_device(queries, device), nqs, pads, params, plan)
        singles = {}
        for i in longs:
            qpad, params = self._single_qpad(group[i])
            singles[i] = (cuda_lib.to_device(qpad, device), params)
        return shorts, longs, batch, singles

    def _chunk_rows(self, tiles, b, group, setup, matrix=None, lengths=None):
        """Scores f32 [len(group), ct x NS] of one chunk of bucket ``b``
        (``tiles`` on the device of ``setup``, ``_stream_setup``'s;
        ``lengths``: its subject lengths for the col kernels, or None)."""
        shorts, longs, batch, singles = setup
        rows: list = [None] * len(group)
        if batch is not None:
            part = self._batch_bucket(tiles, b.kernel, *batch, matrix=matrix, lengths=lengths)
            for slot, i in enumerate(shorts):
                rows[i] = part[slot]
        for i in longs:
            qdev, params = singles[i]
            rows[i] = self._score_bucket(tiles, b.kernel, group[i], qdev, params, True,
                                         matrix, lengths).reshape(-1)
        return torch.stack(rows)

    def _stream_rows(self, group):
        """One pass of the database for encoded queries ``group``: yields,
        per chunk, (scores f32 [len(group), ct x NS], seq_index [ct, NS])
        on the device, in chunk order (resident prefix first)."""
        setup = self._stream_setup(group, self.device)
        for b, tiles, sidx, lens in self._scan_chunks():
            yield self._chunk_rows(tiles, b, group, setup, lengths=lens), sidx

    def _stream_candidates_mesh(self, group) -> Candidates:
        """One pass of the database on a mesh: every local shard scores its
        slice of each chunk and keeps its top N of the chunk on its device;
        at the end each shard's candidates start back to the host (the JAX
        package's sharded chunk scorers and
        ``build_sharded_chunk_candidates``)."""
        setups, cands = [], [[] for _ in self._shards]
        for sh in self._shards:
            with shard_context(sh):
                setups.append(self._stream_setup(group, sh.device))
        for b, parts in self._scan_chunks_mesh():
            for j, (sh, part) in enumerate(zip(self._shards, parts)):
                if part is None:
                    continue
                with shard_span(sh):
                    tiles, sidx, lens = part
                    rows = self._chunk_rows(tiles, b, group, setups[j], sh.matrix, lens)
                    with span("sw:top_n", sh.device):
                        cands[j].append(self._top_n(rows, sidx.reshape(-1).long()))
        out = Candidates(self.mesh, self.results_per_query, len(group))
        for sh, cs in zip(self._shards, cands):
            with shard_context(sh):
                empty = torch.full((len(group), 0), -1, dtype=torch.int64, device=sh.device)
                out.add(sh, torch.cat([v for v, _ in cs], dim=1) if cs else empty,
                        torch.cat([i for _, i in cs], dim=1) if cs else empty)
        return out

    def _scan_streaming_batch(self, group):
        """Stream the database once for up to QB_STREAM encoded queries of
        any length; returns their ScanResults in order (see the module
        docstring for the path, the tie rule and the seconds)."""
        from .engine import BenchmarkStats, ScanResult

        if not group:
            return []
        if self.state16 and not getattr(self, "_warned_state16_stream", False):
            self._warned_state16_stream = True
            print("NOTE: int16 kernel families are ignored in streaming mode "
                  "(always exact int32 state)", file=sys.stderr)
        t0 = time.perf_counter()
        with span("sw:stream_pass", self.device):
            if self.mesh is not None:
                cands = self._stream_candidates_mesh(group)
                with span("sw:readback", self.device):
                    vals, ids = cands.merged()
            else:
                cands = []
                for rows, sidx in self._stream_rows(group):
                    with span("sw:top_n", self.device):
                        cands.append(self._top_n(rows, sidx.reshape(-1).long()))
                with span("sw:readback", self.device):
                    if cands:  # the one read-back of the pass
                        vals = torch.cat([v for v, _ in cands], dim=1).cpu().numpy()
                        ids = torch.cat([i for _, i in cands], dim=1).cpu().numpy()
                    else:
                        vals = ids = np.zeros((len(group), 0), np.int64)
        seconds = time.perf_counter() - t0
        k = self.results_per_query
        db_chars = float(self.packed.total_real_chars)
        total_cells = sum(len(c) for c in group) * db_chars
        out = []
        with span("sw:finish", self.device):
            for i, c in enumerate(group):
                keep = ids[i] >= 0
                scores, rids = vals[i][keep], ids[i][keep]
                order = np.lexsort((rids, -scores))[:k]
                cells = float(len(c)) * db_chars
                self._total_cells += cells
                q_seconds = seconds * cells / total_cells if total_cells else seconds
                out.append(ScanResult(
                    scores=[int(v) for v in scores[order]],
                    reference_ids=[int(r) for r in rids[order]],
                    stats=BenchmarkStats(
                        seconds=q_seconds,
                        gcups=cells / 1e9 / q_seconds if q_seconds > 0 else 0.0,
                    ),
                ))
        if self.debug_check:
            for c, r in zip(group, out):
                self._debug_check_result(c, r)
        return out
