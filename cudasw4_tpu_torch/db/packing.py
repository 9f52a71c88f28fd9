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
to the JAX package's for the same database.

The disk-backed tile store (``save_packed``, ``pack_db_to_store``,
``load_packed``: an npz manifest at ``path`` and the raw tiles at
``path + ".tiles"``) and its transfer-pack sidecar (``path + ".pack5/"``:
one int32 file a bucket and ``manifest.json``) are byte for byte the JAX
package's, so either package reads a store that the other wrote.  The
per-host partial stores (tile ranges) wait for the multi-GPU slice of the
port (A13); tuning waits for its own slice.
"""

from __future__ import annotations

import json
import os
import zipfile
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


def planned_shapes(lengths, edges=None) -> list[tuple]:
    """(L, NS, kernel, tiles) of each bucket that ``pack_db`` would give a
    length-sorted database of these ``lengths``, from the bucket plan
    alone (no packing)."""
    return [(L, NS, kernel, -(-(stop - start) // NS))
            for start, stop, L, NS, kernel in plan_buckets(lengths, edges)]


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


# ------------------------------------------------------------ tile store

#: Version of the tile store's layout and bucket selection; a store of
#: another version is stale.  The JAX package's value: both read one store.
PACK_FORMAT_VERSION = 6

_KERNEL_CODE = {"row": 0, "cell": 1, "col": 2}
_KERNEL_NAME = {v: k for k, v in _KERNEL_CODE.items()}

_PER_HOST = "per-host partial tile stores (tile ranges) wait for the multi-GPU slice of the port (A13)"


def _tiles_bin_path(path: str) -> str:
    return path + ".tiles"


class _store_build_lock:
    """Interprocess lock (flock on ``path + ".lock"``) serialising builds of
    one tile store or sidecar: processes that share a ``pack_cache`` wait
    and then load what the first one built."""

    def __init__(self, path: str):
        self._path = path + ".lock"
        self._f = None

    def __enter__(self):
        import fcntl

        self._f = open(self._path, "w")
        try:
            fcntl.flock(self._f, fcntl.LOCK_EX)
        except OSError:
            self._f.close()  # e.g. a filesystem without flock
            self._f = None
            raise
        return self

    def __exit__(self, *exc):
        import fcntl

        fcntl.flock(self._f, fcntl.LOCK_UN)
        self._f.close()
        return False


def save_packed(packed: PackedDB, path: str, pad_code: int = UNKNOWN) -> None:
    """Write a PackedDB as a tile store: the npz manifest at ``path`` (meta,
    then per bucket seq_index, lengths and info [L, NS, kernel code, T,
    byte offset]) and the raw int8 tiles at ``path + ".tiles"``, so that a
    streaming engine memmaps each bucket instead of holding the database
    in RAM.  Both files are written under temp names and moved in place."""
    arrays = {
        "meta": np.array(
            [PACK_FORMAT_VERSION, packed.num_sequences, packed.total_real_chars,
             len(packed.buckets), pad_code],
            dtype=np.int64,
        ),
    }
    offset = 0
    tmp_bin = f"{_tiles_bin_path(path)}.tmp.{os.getpid()}"
    with open(tmp_bin, "wb") as f:
        for i, b in enumerate(packed.buckets):
            arrays[f"b{i}_idx"] = b.seq_index
            arrays[f"b{i}_len"] = b.lengths
            arrays[f"b{i}_info"] = np.array(
                [b.L, b.NS, _KERNEL_CODE[b.kernel], b.num_tiles, offset], np.int64
            )
            f.write(np.ascontiguousarray(b.tiles).tobytes())
            offset += b.tiles.size
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp_bin, _tiles_bin_path(path))
    os.replace(tmp, path)


def load_packed(path: str, expect_sequences: int, expect_chars: int, mmap: bool = True,
                expect_pad: int = UNKNOWN, need_ranges=None):
    """Load a tile store written by ``save_packed`` or ``pack_db_to_store``
    (either package's); None when it is missing, stale (version, sequence
    or residue count, pad code), unreadable or partial.  ``mmap``: tiles
    stay disk-backed read-only memmaps (the default) or load into RAM.
    ``need_ranges`` (a partial store's tile ranges) raises
    NotImplementedError: it waits for A13."""
    if need_ranges is not None:
        raise NotImplementedError(_PER_HOST)
    if not os.path.exists(path) or not os.path.exists(_tiles_bin_path(path)):
        return None
    try:
        z = np.load(path)
        ver, nseq, nchars, nb, pad = (int(x) for x in z["meta"])
        if (ver != PACK_FORMAT_VERSION or nseq != expect_sequences
                or nchars != expect_chars or pad != expect_pad):
            return None
        if any(f"b{i}_ranges" in z.files for i in range(nb)):
            return None  # a per-host partial store covers only some tiles
        bin_path = _tiles_bin_path(path)
        flat = np.memmap(bin_path, dtype=np.int8, mode="r", shape=(os.path.getsize(bin_path),))
        buckets = []
        for i in range(nb):
            L, NS, kk, T, off = (int(x) for x in z[f"b{i}_info"])
            kernel = _KERNEL_NAME[kk]
            shape = (T, L, 32, NS // 32) if kernel in ("cell", "col") else (T, L, NS)
            tiles = flat[off : off + T * L * NS].reshape(shape)
            buckets.append(PackedBucket(
                L=L, NS=NS, tiles=tiles if mmap else np.array(tiles),
                seq_index=z[f"b{i}_idx"], lengths=z[f"b{i}_len"], kernel=kernel,
            ))
        return PackedDB(buckets=buckets, num_sequences=nseq, total_real_chars=nchars)
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None


def stream_manifest(codec: str, pad_code: int, num_sequences: int, total_chars: int,
                    layout) -> dict:
    """The transfer-pack sidecar's manifest, which every writer writes and
    every reader compares: ``layout`` is (L, NS, kernel, T) per bucket."""
    from ..ops import pack5 as p5

    words_for = p5.CODECS[codec][1]
    return {
        "version": 2,
        "codec": codec,
        "pad": int(pad_code),
        "num_sequences": int(num_sequences),
        "total_chars": int(total_chars),
        "buckets": [
            {"L": int(L), "NS": int(NS), "kernel": kernel, "T": int(T),
             "W": int(words_for(L * NS))}
            for L, NS, kernel, T in layout
        ],
    }


def _packed_layout(packed: PackedDB):
    return [(b.L, b.NS, b.kernel, b.num_tiles) for b in packed.buckets]


def stream_sidecar_fresh(path: str, manifest: dict) -> bool:
    """True if ``path + ".pack5/manifest.json"`` equals ``manifest``: the
    sidecar is present, complete and packed for this store and codec.  A
    sidecar that claims tile ranges (a per-host one) is not fresh."""
    try:
        with open(os.path.join(path + ".pack5", "manifest.json")) as f:
            return json.load(f) == manifest
    except (OSError, ValueError):
        return False


def _write_manifest(sidecar: str, manifest: dict) -> None:
    """Publish a sidecar's manifest atomically, after its data."""
    tmp = os.path.join(sidecar, f"manifest.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(sidecar, "manifest.json"))


def _drop_manifest(sidecar: str) -> None:
    """Invalidate a sidecar before its data files are rewritten, so that an
    interrupted build never validates."""
    try:
        os.remove(os.path.join(sidecar, "manifest.json"))
    except FileNotFoundError:
        pass


def build_stream_sidecar(packed: PackedDB, path: str, stream_codec: str,
                         pad_code: int = UNKNOWN, slab_tiles: int = 64) -> bool:
    """Build the ``path + ".pack5/"`` sidecar from an existing (memmapped)
    tile store in one pass of ``slab_tiles`` tiles at a time.  Returns
    True when it was written, False where the directory is not writable."""
    from ..ops import pack5 as p5

    _cpw, words_for, s_pack = p5.CODECS[stream_codec][:3]
    if int(pad_code) > p5.CODECS[stream_codec][5]:
        raise ValueError(f"pad code {pad_code} exceeds codec {stream_codec}")
    sidecar = path + ".pack5"
    try:
        os.makedirs(sidecar, exist_ok=True)
        _drop_manifest(sidecar)
        for bi, b in enumerate(packed.buckets):
            T = b.num_tiles
            if T == 0:
                continue
            mm = np.memmap(os.path.join(sidecar, f"b{bi}.bin"), np.int32, mode="w+",
                           shape=(T, words_for(b.L * b.NS)))
            for t0 in range(0, T, slab_tiles):
                t1 = min(t0 + slab_tiles, T)
                s_pack(np.ascontiguousarray(b.tiles[t0:t1]), out=mm[t0:t1])
            del mm
        _write_manifest(sidecar, stream_manifest(
            stream_codec, pad_code, packed.num_sequences, packed.total_real_chars,
            _packed_layout(packed),
        ))
        return True
    except (OSError, ValueError):
        return False


def pack_db_to_store(db, path: str, edges=None, slab_tiles: int = 64,
                     pad_code: int = UNKNOWN, stream_codec: str | None = None,
                     tile_ranges=None) -> PackedDB:
    """Pack a length-sorted database straight into a tile store, one slab
    of ``slab_tiles`` tiles in RAM at a time; returns the store loaded with
    memmapped tiles (the files equal ``save_packed(pack_db(db), path)``'s).

    ``stream_codec`` (a codec of ops/pack5.py): also build the
    ``path + ".pack5/"`` sidecar in the same pass, each slab packed while
    it is in RAM; the sidecar is best-effort, and a write failure drops it
    while the store is still built.  Under the build lock: a store another
    process built meanwhile with the same bucket layout is loaded (and
    given the sidecar it lacks) instead of built again.  ``tile_ranges``
    raises NotImplementedError: per-host stores wait for A13."""
    if tile_ranges is not None:
        raise NotImplementedError(_PER_HOST)
    lengths = np.asarray(db.lengths, dtype=np.int64)
    offsets = np.asarray(db.offsets, dtype=np.int64)
    chars = np.asarray(db.chars)
    n = len(lengths)
    if n and not np.all(lengths[1:] >= lengths[:-1]):
        raise ValueError("database is not sorted by length ascending")
    nchars = int(lengths.sum())
    plans = plan_buckets(lengths, edges)
    layout = [(L, NS, kernel, -(-(stop - start) // NS)) for start, stop, L, NS, kernel in plans]

    with _store_build_lock(path):
        prior = load_packed(path, n, nchars, expect_pad=pad_code)
        if prior is not None and _packed_layout(prior) == layout:
            if stream_codec is not None and not stream_sidecar_fresh(
                path, stream_manifest(stream_codec, pad_code, n, nchars, layout)
            ):
                build_stream_sidecar(prior, path, stream_codec, pad_code=pad_code,
                                     slab_tiles=slab_tiles)
            return prior
        sidecar = s_words = s_pack = None
        if stream_codec is not None:
            from ..ops import pack5 as p5

            _cpw, s_words, s_pack = p5.CODECS[stream_codec][:3]
            if int(pad_code) > p5.CODECS[stream_codec][5]:
                raise ValueError(f"pad code {pad_code} exceeds codec {stream_codec}")
            sidecar = path + ".pack5"
            try:
                os.makedirs(sidecar, exist_ok=True)
                _drop_manifest(sidecar)
            except OSError:
                sidecar = None
        arrays = {}
        offset = 0
        tmp_bin = f"{_tiles_bin_path(path)}.tmp.{os.getpid()}"
        with open(tmp_bin, "wb") as f:
            for nb, (start, stop, L, NS, kernel) in enumerate(plans):
                T = -(-(stop - start) // NS)
                pk_mm = None
                if sidecar and T:
                    try:
                        pk_mm = np.memmap(os.path.join(sidecar, f"b{nb}.bin"), np.int32,
                                          mode="w+", shape=(T, s_words(L * NS)))
                    except (OSError, ValueError):
                        sidecar = None
                idx_parts, len_parts = [], []
                for a in range(start, stop, slab_tiles * NS):
                    b = min(a + slab_tiles * NS, stop)
                    tiles, sidx, slen = _pack_slab(chars, offsets, lengths, a, b, L, NS, pad_code)
                    f.write(np.ascontiguousarray(tiles).data)
                    if pk_mm is not None and sidecar:
                        t0 = (a - start) // NS
                        try:
                            s_pack(tiles, out=pk_mm[t0 : t0 + len(tiles)])
                        except OSError:
                            sidecar = None
                    idx_parts.append(sidx)
                    len_parts.append(slen)
                del pk_mm
                arrays[f"b{nb}_idx"] = np.concatenate(idx_parts)
                arrays[f"b{nb}_len"] = np.concatenate(len_parts)
                arrays[f"b{nb}_info"] = np.array(
                    [L, NS, _KERNEL_CODE[kernel], T, offset], np.int64
                )
                offset += T * L * NS
        arrays["meta"] = np.array([PACK_FORMAT_VERSION, n, nchars, len(plans), pad_code], np.int64)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as fm:
            np.savez(fm, **arrays)
        os.replace(tmp_bin, _tiles_bin_path(path))
        os.replace(tmp, path)
        if sidecar:
            try:
                _write_manifest(sidecar, stream_manifest(stream_codec, pad_code, n, nchars, layout))
            except OSError:
                pass
    return load_packed(path, n, nchars, expect_pad=pad_code)


def unpack_tile_sequences(bucket: PackedBucket, tile: int) -> list[np.ndarray]:
    """The real sequences of one tile, in lane order (the inverse of
    packing; for tests)."""
    tiles = bucket.tiles[tile]
    if tiles.ndim == 3:  # cell layout [L, 32, NS // 32] -> [L, NS]
        tiles = tiles.reshape(bucket.L, bucket.NS)
    out = []
    for s in range(bucket.NS):
        if bucket.seq_index[tile, s] < 0:
            continue
        out.append(tiles[: int(bucket.lengths[tile, s]), s].copy())
    return out
