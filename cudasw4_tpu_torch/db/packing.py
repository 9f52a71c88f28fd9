"""Length-bucketed packing of a database into fixed-shape tiles (the port's
counterpart of the in-memory core of cudasw4_tpu/db/packing.py).

Every sequence goes to the smallest bucket length >= its length, and each
bucket packs into tiles of ``NS`` subjects, position-major: axis 1 of a
tile is the subject *position* j, the last axes the subject *lane*.
Padding positions and padding lanes carry the pad code (its matrix row is
all negative, so it can never raise a local-alignment score); padding
lanes are masked out by ``seq_index == -1``.

Three layouts, chosen per bucket by ``choose_bucket_layout``:

* ``"row"``:  tiles int8 [T, L, 128], for buckets too sparse to fill a
  4096-subject tile;
* ``"cell"``: tiles int8 [T, L, 32, 128], L <= CELL_MAX_L (a pure reshape
  of [T, L, 4096]);
* ``"col"``:  the cell layout for the long tail, L a multiple of
  ``ops.sw_col.LC``, each bucket a run of 4096-sequence chunks padded to a
  ladder length.

The geometry constants are the port's own copies: the JAX package's
``apply_tuning`` rewrites its module globals at run time, and the port
must not follow them.  The bucket plan and the tile bytes are identical
to the JAX package's for the same database.  The disk-backed tile store,
the pack sidecar and tuning are later slices of the port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import UNKNOWN

#: Default bucket edges (ascending), all multiples of 16.
DEFAULT_BUCKET_EDGES = [
    32, 48, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 384, 448,
    512, 640, 768, 896, 1024, 1280, 1536, 1792, 2048,
]

#: Row-layout buckets longer than this are "long" (the JAX package scores
#: them with its portable scorer; the port's row kernel has no cap).
MAX_SINGLE_PASS = 2048
LONG_CHUNK = 2048

#: Lanes per row-layout tile.
MIN_LANES = 128

#: Cell/col tiles hold 32 x 128 subjects; the cell layout serves buckets
#: up to CELL_MAX_L, the col layout the long tail beyond it.
CELL_SUBJECTS = 4096
CELL_MAX_L = 768

#: Kernel speed ratios against the row kernel that the layout chooser
#: weighs against padding waste.  They are the JAX package's defaults, so
#: both packages pack a database identically; ratios measured for the
#: Hopper kernels wait for the tuning slice of the port.
CELL_SPEEDUP = 1.75
COL_SPEEDUP = 2.8
#: Relative speed the layout chooser assumes for row-layout buckets
#: longer than MAX_SINGLE_PASS.
JNP_REL_SPEED = 0.05


def ladder_length(length: int) -> int:
    """Padded length for a long-tail (> CELL_MAX_L) 4096-subject group: the
    group's max length rounded up to the col kernel's 128-column chunk,
    with coarser granules higher up."""
    if length <= 4096:
        return -(-length // 128) * 128
    if length <= 16384:
        return -(-length // 512) * 512
    return -(-length // 4096) * 4096


def adaptive_edges(num_seqs: int):
    """Fine (16-step) bucket edges for databases of 2M sequences or more,
    or None to keep DEFAULT_BUCKET_EDGES."""
    if num_seqs >= 2_000_000:
        return list(range(16, CELL_MAX_L + 1, 16))
    return None


def lanes_for_length(L: int) -> int:
    return MIN_LANES


def choose_bucket_layout(L: int, count: int) -> tuple[int, str]:
    """Returns (NS, kernel) maximising effective throughput for the bucket
    after padding waste."""
    from ..ops.sw_col import LC

    row_ns = lanes_for_length(L)
    row_eff = count / (-(-count // row_ns) * row_ns)
    wide_eff = count / (-(-count // CELL_SUBJECTS) * CELL_SUBJECTS)
    if L <= CELL_MAX_L:
        if wide_eff * CELL_SPEEDUP > row_eff:
            return CELL_SUBJECTS, "cell"
        return row_ns, "row"
    if L % LC == 0:
        row_rel = 1.0 if L <= MAX_SINGLE_PASS else JNP_REL_SPEED
        if wide_eff * COL_SPEEDUP > row_eff * row_rel:
            return CELL_SUBJECTS, "col"
    return row_ns, "row"


def bucket_length_for(length: int, edges=None) -> int:
    """Smallest bucket length >= ``length``."""
    if edges is None:
        edges = DEFAULT_BUCKET_EDGES
    for e in edges:
        if length <= e:
            return e
    return ((length + LONG_CHUNK - 1) // LONG_CHUNK) * LONG_CHUNK


@dataclass
class PackedBucket:
    """One bucket of the packed database (host arrays)."""

    L: int  # padded subject length
    NS: int  # subjects per tile
    tiles: np.ndarray  # int8 [T, L, NS] ("row") or [T, L, 32, NS // 32]
    seq_index: np.ndarray  # int32 [T, NS], global (sorted-db) id, -1 = padding
    lengths: np.ndarray  # int32 [T, NS], real lengths, 0 = padding
    kernel: str = "row"  # "row" | "cell" | "col"

    @property
    def num_tiles(self) -> int:
        return self.tiles.shape[0]

    @property
    def num_real(self) -> int:
        return int((self.seq_index >= 0).sum())

    @property
    def is_long(self) -> bool:
        return self.L > MAX_SINGLE_PASS


@dataclass
class PackedDB:
    buckets: list[PackedBucket]
    num_sequences: int
    total_real_chars: int  # sum of real lengths (GCUPS denominator)

    @property
    def total_padded_chars(self) -> int:
        return sum(b.tiles.size for b in self.buckets)


def _pack_slab(chars, offsets, lengths, a, b, L, NS, pad_code):
    """Pack sequences [a, b) into ceil((b-a)/NS) position-major row-layout
    tiles; returns (tiles [nt, L, NS], seq_index [nt, NS], lengths [nt, NS])."""
    cnt = b - a
    nt = -(-cnt // NS)
    offs = offsets[a:b, None]  # [cnt, 1]
    jj = np.arange(L, dtype=np.int64)[None, :]
    # padded length on disk is a multiple of 4 >= real length
    padlens = ((lengths[a:b] + 3) // 4 * 4)[:, None]
    idx = offs + np.minimum(jj, padlens - 1)
    block = np.take(chars, idx)
    if pad_code == UNKNOWN:
        # On-disk padding bytes within [len, padlen) are already UNKNOWN;
        # masking at padlens keeps byte parity with the JAX package.
        block = np.where(jj < padlens, block, UNKNOWN)
    else:
        block = np.where(jj < lengths[a:b, None], block, pad_code)
    block = block.astype(np.int8)
    slab = np.full((nt * NS, L), pad_code, dtype=np.int8)
    slab[:cnt] = block
    tiles = slab.reshape(nt, NS, L).transpose(0, 2, 1)
    sidx = np.full(nt * NS, -1, dtype=np.int32)
    sidx[:cnt] = np.arange(a, b, dtype=np.int32)
    slen = np.zeros(nt * NS, dtype=np.int32)
    slen[:cnt] = lengths[a:b]
    return tiles, sidx.reshape(nt, NS), slen.reshape(nt, NS)


def pack_db(db, edges=None, slab_tiles: int = 64, pad_code: int = UNKNOWN) -> PackedDB:
    """Pack a length-sorted DBData into buckets of fixed-shape tiles.

    ``db`` needs .chars/.offsets/.lengths, sorted by length ascending (the
    on-disk invariant), so each bucket is a contiguous id range.
    ``pad_code``: code for padded positions (UNKNOWN classic; 25 in
    full-blosum mode, where on-disk code 20 means 'B').
    """
    lengths = np.asarray(db.lengths, dtype=np.int64)
    offsets = np.asarray(db.offsets, dtype=np.int64)
    chars = np.asarray(db.chars)
    n = len(lengths)
    if n and not np.all(lengths[1:] >= lengths[:-1]):
        raise ValueError("database is not sorted by length ascending")

    buckets: list[PackedBucket] = []
    for start, stop, L, NS, kernel in plan_buckets(lengths, edges):
        T = -(-(stop - start) // NS)
        tiles = np.full((T, L, NS), pad_code, dtype=np.int8)
        seq_index = np.full((T, NS), -1, dtype=np.int32)
        seq_lengths = np.zeros((T, NS), dtype=np.int32)
        # Fill tiles in slabs to bound temp memory.
        for t0 in range(0, T, slab_tiles):
            t1 = min(t0 + slab_tiles, T)
            a = start + t0 * NS
            b = min(start + t1 * NS, stop)
            tiles[t0:t1], seq_index[t0:t1], seq_lengths[t0:t1] = _pack_slab(
                chars, offsets, lengths, a, b, L, NS, pad_code
            )
        if kernel in ("cell", "col"):
            tiles = tiles.reshape(T, L, 32, NS // 32)
        buckets.append(PackedBucket(
            L=L, NS=NS, tiles=tiles, seq_index=seq_index,
            lengths=seq_lengths, kernel=kernel,
        ))
    return PackedDB(buckets=buckets, num_sequences=n, total_real_chars=int(lengths.sum()))


def plan_buckets(lengths, edges=None):
    """Bucket plan for a length-sorted database: list of
    (start, stop, L, NS, kernel) sequence ranges.

    The short part uses the edges up to CELL_MAX_L; the long tail packs
    top-down chunks of CELL_SUBJECTS consecutive sequences, each padded to
    a ladder length just above its longest member, with adjacent equal-L
    chunks merged.
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    n = len(lengths)
    if edges is None:
        edges = adaptive_edges(n) or DEFAULT_BUCKET_EDGES
    plan: list[tuple] = []
    start = 0
    for edge in [e for e in edges if e <= CELL_MAX_L]:
        stop = int(np.searchsorted(lengths, edge + 1, side="left"))
        if stop > start:
            NS, kernel = choose_bucket_layout(edge, stop - start)
            plan.append((start, stop, edge, NS, kernel))
        start = stop
    if start < n:
        long_start = start
        chunk_runs: list[list] = []  # [lo, hi, L], descending
        i = n
        while i > long_start:
            j = max(long_start, i - CELL_SUBJECTS)
            L = ladder_length(int(lengths[i - 1]))
            if chunk_runs and chunk_runs[-1][2] == L:
                chunk_runs[-1][0] = j
            else:
                chunk_runs.append([j, i, L])
            i = j
        for lo, hi, L in reversed(chunk_runs):
            NS, kernel = choose_bucket_layout(L, hi - lo)
            plan.append((lo, hi, L, NS, kernel))
    return plan


def packed_from_arrays(buckets, num_sequences: int, total_real_chars: int) -> PackedDB:
    """Build a PackedDB from plain arrays: ``buckets`` is an iterable of
    mappings with the keys L, NS, kernel, tiles, seq_index and lengths, as
    the JAX package's PackedBucket holds them.  Lets a caller hand the
    identical packed database to both packages."""
    out = []
    for b in buckets:
        out.append(PackedBucket(
            L=int(b["L"]),
            NS=int(b["NS"]),
            tiles=np.ascontiguousarray(b["tiles"], dtype=np.int8),
            seq_index=np.asarray(b["seq_index"], dtype=np.int32),
            lengths=np.asarray(b["lengths"], dtype=np.int32),
            kernel=str(b["kernel"]),
        ))
    return PackedDB(
        buckets=out,
        num_sequences=int(num_sequences),
        total_real_chars=int(total_real_chars),
    )
