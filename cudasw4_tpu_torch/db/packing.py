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
package's, so either package reads a store that the other wrote.  A
per-host partial store (``tile_ranges``) packs only the tiles that one
process of a streamed mesh reads into a sparse file of the full size and
records its ranges; a later build with other ranges extends it in place.

A tuning config (``apply_tuning``; ``cli/gridsearch.py --emit-config``
writes one) sets the layout chooser's speed ratios, ``CELL_MAX_L`` and the
col kernels' NQC and LC.  A config in ``cudasw4_tpu_torch/tuning/`` whose
``platform`` is the CUDA device's name applies by default
(``auto_apply_tuning``, which the engine calls on a card);
``CUDASW4_TPU_TORCH_TUNING`` names one to apply at import.
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
#: weighs against padding waste.  The defaults are the JAX package's, so
#: both packages pack a database identically; a tuning config
#: (``apply_tuning``) sets measured ones.
CELL_SPEEDUP = 1.75
COL_SPEEDUP = 2.8
#: Relative speed the layout chooser assumes for row-layout buckets
#: longer than MAX_SINGLE_PASS.
JNP_REL_SPEED = 0.05


#: Environment variables: a tuning config to apply at import, and "0" to
#: keep the packaged configs from applying (``auto_apply_tuning``).
TUNING_ENV = "CUDASW4_TPU_TORCH_TUNING"
AUTO_TUNING_ENV = "CUDASW4_TPU_TORCH_AUTO_TUNING"

#: The packaged configs, one a device: ``platform`` is the name that
#: ``torch.cuda.get_device_name`` gives.
TUNING_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tuning")

#: Set by apply_tuning: once any config has been applied in this process
#: (the environment, ``align --tuning`` or a packaged one),
#: ``auto_apply_tuning`` does nothing, so an explicit config wins.
_tuning_applied = False


def apply_tuning(cfg) -> None:
    """Apply a tuning config: a dict, or the path of a JSON file as
    ``gridsearch --emit-config`` writes it (the JAX package's
    ``apply_tuning``, with the port's limits).

    Keys (others are ignored, so configs stay forward compatible):

    - ``cell_speedup`` / ``col_speedup``: the cell and col kernels' speed
      against the row kernel (floats), the layout chooser's ratios.
    - ``cell_max_l``: the longest cell bucket, a multiple of 16 up to the
      largest cell group instance (max G x R of ``sw_cell.CELL_SHAPES``,
      768).
    - ``col_nqc`` / ``col_lc``: ``sw_col.NQC`` (query rows a col call) and
      ``sw_col.LC`` (the col buckets' length granule), multiples of 128.
    - ``cell_unroll`` / ``col_unroll``: validated as the JAX package
      validates them (``cell_unroll`` >= 2; ``col_unroll`` divides
      ``sw_col.FLAT_QUANT``) and not applied: the port's kernels have no
      unroll, and ``sw_cell.DEFAULT_UNROLL`` is the contract's row granule,
      not a speed setting.

    Every key is validated before any is applied: an invalid value raises
    ValueError and applies nothing.
    """
    global CELL_SPEEDUP, COL_SPEEDUP, CELL_MAX_L, _tuning_applied
    if isinstance(cfg, (str, os.PathLike)):
        with open(cfg) as f:
            cfg = json.load(f)
    from ..ops import sw_cell, sw_col

    pend: dict = {}
    if cfg.get("cell_speedup"):
        pend["cell_speedup"] = float(cfg["cell_speedup"])
    if cfg.get("col_speedup"):
        pend["col_speedup"] = float(cfg["col_speedup"])
    if cfg.get("cell_max_l"):
        v = int(cfg["cell_max_l"])
        top = max(g * r for g, r in sw_cell.CELL_SHAPES)
        if v < 16 or v % 16 or v > top:
            raise ValueError(f"cell_max_l must be a multiple of 16 up to {top}: {v}")
        pend["cell_max_l"] = v
    if cfg.get("cell_unroll"):
        v = int(cfg["cell_unroll"])
        if v < 2:
            raise ValueError(f"cell_unroll must be >= 2: {v}")
    if cfg.get("col_unroll"):
        v = int(cfg["col_unroll"])
        if v < 1 or v > sw_col.FLAT_QUANT:
            raise ValueError(f"col_unroll out of range: {v}")
        if sw_col.FLAT_QUANT % v:
            raise ValueError(f"col_unroll must divide FLAT_QUANT ({sw_col.FLAT_QUANT}): {v}")
    for key in ("col_nqc", "col_lc"):
        if cfg.get(key):
            v = int(cfg[key])
            if v < 128 or v % 128:
                raise ValueError(f"{key} must be a multiple of 128: {v}")
            pend[key] = v
    CELL_SPEEDUP = pend.get("cell_speedup", CELL_SPEEDUP)
    COL_SPEEDUP = pend.get("col_speedup", COL_SPEEDUP)
    CELL_MAX_L = pend.get("cell_max_l", CELL_MAX_L)
    sw_col.NQC = pend.get("col_nqc", sw_col.NQC)
    sw_col.LC = pend.get("col_lc", sw_col.LC)
    _tuning_applied = True


def auto_apply_tuning(device_name: str, verbose: bool = False) -> str | None:
    """Apply the packaged config of TUNING_DIR whose ``platform`` is
    ``device_name`` (``torch.cuda.get_device_name``), as the reference's
    built-in dispatch table is its default.  Returns its path, or None: no
    config matches, a config was applied already, or
    ``CUDASW4_TPU_TORCH_AUTO_TUNING=0``.  Never raises: a malformed
    packaged config is skipped."""
    if _tuning_applied or os.environ.get(AUTO_TUNING_ENV, "1") == "0":
        return None
    try:
        names = sorted(os.listdir(TUNING_DIR))
    except OSError:
        return None
    for name in names:
        if not name.endswith(".json"):
            continue
        path = os.path.join(TUNING_DIR, name)
        try:
            with open(path) as f:
                cfg = json.load(f)
            if cfg.get("platform") != device_name:
                continue
            apply_tuning(cfg)
        except (OSError, ValueError, TypeError, AttributeError):
            continue
        if verbose:
            print(f"Applied the packaged {device_name} tuning: {path} "
                  f"(opt out: {AUTO_TUNING_ENV}=0)")
        return path
    return None


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
    #: Per bucket, the [(t_start, t_stop), ...] tile ranges a partial
    #: (per-host) store holds; None when it holds every tile.  Tiles
    #: outside them read as zeros and are never scored: only a streamed
    #: mesh pass, whose shards' rows they were made from, takes such a store.
    tile_ranges: list | None = None

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

    from ..native import pack_bucket_native

    lengths32 = lengths.astype(np.int32)
    buckets: list[PackedBucket] = []
    for start, stop, L, NS, kernel in plan_buckets(lengths, edges):
        T = -(-(stop - start) // NS)
        native = pack_bucket_native(chars, offsets, lengths32, start, stop, L, NS, pad=pad_code)
        if native is not None:
            tiles, seq_index, seq_lengths = native
        else:
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


def _tiles_bin_path(path: str) -> str:
    return path + ".tiles"


def _norm_ranges(ranges, T: int) -> list:
    """Tile ranges clipped to [0, T), empty ones dropped, sorted and merged
    where they overlap or touch: the form manifests store and the coverage
    checks compare."""
    out: list = []
    for a, b in sorted((max(0, int(a)), min(T, int(b))) for a, b in ranges):
        if a >= b:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _ranges_cover(have: list, need: list) -> bool:
    """Whether every range of ``need`` lies inside one range of ``have``
    (both normalised)."""
    i = 0
    for a, b in need:
        while i < len(have) and have[i][1] < b:
            i += 1
        if i == len(have) or have[i][0] > a:
            return False
    return True


def _ranges_subtract(need: list, have: list) -> list:
    """Normalised ``need`` less normalised ``have``: the ranges an extension
    of a partial store still packs."""
    out = []
    for a, b in need:
        cur = a
        for c, d in have:
            if d <= cur or c >= b:
                continue
            if c > cur:
                out.append((cur, c))
            cur = max(cur, d)
            if cur >= b:
                break
        if cur < b:
            out.append((cur, b))
    return out


def _full_ranges(Ts) -> list:
    """The ranges of a complete store of buckets of ``Ts`` tiles."""
    return [[(0, T)] if T else [] for T in Ts]


def _bucket_meta_arrays(start: int, stop: int, NS: int, lengths):
    """seq_index and lengths [T, NS] of the bucket of sequences [start,
    stop), from the lengths alone: slot s of tile t is sequence start +
    t * NS + s (what ``_pack_slab`` gives, slab by slab)."""
    cnt = stop - start
    T = -(-cnt // NS)
    sidx = np.full(T * NS, -1, dtype=np.int32)
    sidx[:cnt] = np.arange(start, stop, dtype=np.int32)
    slen = np.zeros(T * NS, dtype=np.int32)
    slen[:cnt] = lengths[start:stop]
    return sidx.reshape(T, NS), slen.reshape(T, NS)


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
    or residue count, pad code) or unreadable, or does not hold the tiles
    asked for.  ``mmap``: tiles stay disk-backed read-only memmaps (the
    default) or load into RAM.

    ``need_ranges``: per bucket, the tile ranges the caller reads.  None
    asks for every tile; "any" takes a store of any coverage (the
    extension's probe); else a partial store is taken when its ranges
    cover them.  A partial store comes back with its ``tile_ranges``."""
    if not os.path.exists(path) or not os.path.exists(_tiles_bin_path(path)):
        return None
    try:
        z = np.load(path)
        ver, nseq, nchars, nb, pad = (int(x) for x in z["meta"])
        if (ver != PACK_FORMAT_VERSION or nseq != expect_sequences
                or nchars != expect_chars or pad != expect_pad):
            return None
        if need_ranges is not None and need_ranges != "any" and len(need_ranges) != nb:
            return None
        bin_path = _tiles_bin_path(path)
        flat = np.memmap(bin_path, dtype=np.int8, mode="r", shape=(os.path.getsize(bin_path),))
        buckets, ranges = [], []
        for i in range(nb):
            L, NS, kk, T, off = (int(x) for x in z[f"b{i}_info"])
            kernel = _KERNEL_NAME[kk]
            full = _full_ranges([T])[0]
            rk = f"b{i}_ranges"
            have = (_norm_ranges([tuple(r) for r in z[rk].reshape(-1, 2)], T)
                    if rk in z.files else full)
            ranges.append(have)
            if need_ranges != "any":
                need = full if need_ranges is None else _norm_ranges(need_ranges[i], T)
                if not _ranges_cover(have, need):
                    return None
            shape = (T, L, 32, NS // 32) if kernel in ("cell", "col") else (T, L, NS)
            tiles = flat[off : off + T * L * NS].reshape(shape)
            buckets.append(PackedBucket(
                L=L, NS=NS, tiles=tiles if mmap else np.array(tiles),
                seq_index=z[f"b{i}_idx"], lengths=z[f"b{i}_len"], kernel=kernel,
            ))
        partial = ranges != _full_ranges([b.num_tiles for b in buckets])
        return PackedDB(buckets=buckets, num_sequences=nseq, total_real_chars=nchars,
                        tile_ranges=ranges if partial else None)
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None


def stream_manifest(codec: str, pad_code: int, num_sequences: int, total_chars: int,
                    layout, ranges=None) -> dict:
    """The transfer-pack sidecar's manifest, which every writer writes and
    every reader compares: ``layout`` is (L, NS, kernel, T) per bucket.
    ``ranges``: the tile ranges a partial (per-host) sidecar holds, written
    only when they are not the whole of every bucket."""
    from ..ops import pack5 as p5

    words_for = p5.CODECS[codec][1]
    man = {
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
    if ranges is not None:
        Ts = [int(T) for _, _, _, T in layout]
        norm = [_norm_ranges(r, T) for r, T in zip(ranges, Ts)]
        if norm != _full_ranges(Ts):
            man["ranges"] = [[[int(a), int(b)] for a, b in r] for r in norm]
    return man


def _packed_layout(packed: PackedDB):
    return [(b.L, b.NS, b.kernel, b.num_tiles) for b in packed.buckets]


def stream_sidecar_fresh(path: str, manifest: dict, need_ranges=None) -> bool:
    """True if ``path + ".pack5/manifest.json"`` matches ``manifest`` (its
    "ranges" aside) and its tile ranges (none: all) cover ``need_ranges``:
    None asks for every tile, "any" for the layout alone (the extension's
    probe)."""
    try:
        with open(os.path.join(path + ".pack5", "manifest.json")) as f:
            stored = json.load(f)
    except (OSError, ValueError):
        return False
    s_ranges = stored.pop("ranges", None)
    if stored != {k: v for k, v in manifest.items() if k != "ranges"}:
        return False
    if need_ranges == "any":
        return True
    Ts = [int(b["T"]) for b in stored["buckets"]]
    have = (_full_ranges(Ts) if s_ranges is None
            else [_norm_ranges(r, T) for r, T in zip(s_ranges, Ts)])
    if need_ranges is None:
        need = _full_ranges(Ts)
    elif len(need_ranges) != len(Ts):
        return False
    else:
        need = [_norm_ranges(r, T) for r, T in zip(need_ranges, Ts)]
    return all(_ranges_cover(h, n) for h, n in zip(have, need))


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
    tile store in one pass of ``slab_tiles`` tiles at a time; a partial
    store's sidecar claims the store's ranges only.  Returns True when it
    was written, False where the directory is not writable."""
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
            _packed_layout(packed), ranges=packed.tile_ranges,
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
    while the store is still built.  ``tile_ranges``: per bucket of the
    plan, the [(t_start, t_stop), ...] tiles to pack (a per-host store:
    a sparse tiles file of the full size, the ranges in the manifest;
    seq_index and lengths cover every tile); None packs all.  Under the
    build lock: a store another process built meanwhile with the same
    bucket layout is loaded (and given the sidecar it lacks), or, when it
    lacks some requested ranges, extended in place (``_extend_store``)."""
    lengths = np.asarray(db.lengths, dtype=np.int64)
    offsets = np.asarray(db.offsets, dtype=np.int64)
    chars = np.asarray(db.chars)
    n = len(lengths)
    if n and not np.all(lengths[1:] >= lengths[:-1]):
        raise ValueError("database is not sorted by length ascending")
    nchars = int(lengths.sum())
    plans = plan_buckets(lengths, edges)
    layout = [(L, NS, kernel, -(-(stop - start) // NS)) for start, stop, L, NS, kernel in plans]
    Ts = [T for _, _, _, T in layout]
    if tile_ranges is not None and len(tile_ranges) != len(plans):
        raise ValueError(f"tile_ranges has {len(tile_ranges)} buckets, the plan {len(plans)}")
    full = _full_ranges(Ts)
    req = full if tile_ranges is None else [_norm_ranges(r, T) for r, T in zip(tile_ranges, Ts)]
    partial = req != full

    from ..native import pack_bucket_native

    lengths32 = lengths.astype(np.int32)

    def pack_slab(a, b, L, NS):
        native = pack_bucket_native(chars, offsets, lengths32, a, b, L, NS, pad=pad_code)
        if native is not None:
            return native
        return _pack_slab(chars, offsets, lengths, a, b, L, NS, pad_code)

    with _store_build_lock(path):
        prior = load_packed(path, n, nchars, expect_pad=pad_code, need_ranges="any")
        if prior is not None and _packed_layout(prior) == layout:
            have = prior.tile_ranges or full
            missing = [_ranges_subtract(r, h) for r, h in zip(req, have)]
            if any(missing):
                del prior  # its memmap goes before the tiles file is written
                return _extend_store(path, plans, Ts, missing, have, req, pack_slab,
                                     slab_tiles, stream_codec, pad_code, n, nchars, layout)
            if stream_codec is not None and not stream_sidecar_fresh(
                path, stream_manifest(stream_codec, pad_code, n, nchars, layout),
                need_ranges=req,
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
            if partial:  # sparse: the offsets of a complete store, only the ranges written
                f.truncate(sum(T * L * NS for (L, NS, _, T) in layout))
            for nb, ((start, stop, L, NS, kernel), rq) in enumerate(zip(plans, req)):
                T = -(-(stop - start) // NS)
                pk_mm = None
                if sidecar and T:
                    try:
                        pk_mm = np.memmap(os.path.join(sidecar, f"b{nb}.bin"), np.int32,
                                          mode="w+", shape=(T, s_words(L * NS)))
                    except (OSError, ValueError):
                        sidecar = None

                def put(tiles, t0):
                    nonlocal sidecar
                    f.write(np.ascontiguousarray(tiles).data)
                    if pk_mm is not None and sidecar:
                        try:
                            s_pack(tiles, out=pk_mm[t0 : t0 + len(tiles)])
                        except OSError:
                            sidecar = None

                if partial:
                    arrays[f"b{nb}_idx"], arrays[f"b{nb}_len"] = _bucket_meta_arrays(
                        start, stop, NS, lengths)
                    arrays[f"b{nb}_ranges"] = np.asarray(rq, np.int64).reshape(-1, 2)
                    for t0r, t1r in rq:
                        hi = min(stop, start + t1r * NS)
                        for a in range(start + t0r * NS, hi, slab_tiles * NS):
                            tiles = pack_slab(a, min(a + slab_tiles * NS, hi), L, NS)[0]
                            t0 = (a - start) // NS
                            f.seek(offset + t0 * L * NS)
                            put(tiles, t0)
                else:
                    idx_parts, len_parts = [], []
                    for a in range(start, stop, slab_tiles * NS):
                        tiles, sidx, slen = pack_slab(a, min(a + slab_tiles * NS, stop), L, NS)
                        put(tiles, (a - start) // NS)
                        idx_parts.append(sidx)
                        len_parts.append(slen)
                    arrays[f"b{nb}_idx"] = np.concatenate(idx_parts)
                    arrays[f"b{nb}_len"] = np.concatenate(len_parts)
                del pk_mm
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
                _write_manifest(sidecar, stream_manifest(stream_codec, pad_code, n, nchars, layout,
                                                         ranges=req if partial else None))
            except OSError:
                pass
    return load_packed(path, n, nchars, expect_pad=pad_code, need_ranges=req)


def _extend_store(path, plans, Ts, missing, have, req, pack_slab, slab_tiles, stream_codec,
                  pad_code, n, nchars, layout):
    """Pack the ``missing`` tile ranges into an existing partial store in
    place, then publish the union of ``have`` and ``req`` in its manifest
    (and the sidecar's, where its layout matches: its rows are written
    too).  Runs under the build lock; the data goes before the manifests,
    so an interrupted extension never claims tiles it did not write."""
    sc_fresh = False
    e_words = e_pack = None
    if stream_codec is not None:
        from ..ops import pack5 as p5

        _cpw, e_words, e_pack = p5.CODECS[stream_codec][:3]
        sc_fresh = stream_sidecar_fresh(
            path, stream_manifest(stream_codec, pad_code, n, nchars, layout), need_ranges="any")
    with open(_tiles_bin_path(path), "r+b") as f:
        offset = 0
        for bi, ((start, stop, L, NS, _kernel), miss, T) in enumerate(zip(plans, missing, Ts)):
            pk_mm = None
            if sc_fresh and miss and T:
                try:
                    pk_mm = np.memmap(os.path.join(path + ".pack5", f"b{bi}.bin"), np.int32,
                                      mode="r+", shape=(T, e_words(L * NS)))
                except (OSError, ValueError):
                    sc_fresh = False  # a half-extended sidecar must not validate
                    try:
                        _drop_manifest(path + ".pack5")
                    except OSError:
                        pass
            for t0r, t1r in miss:
                hi = min(stop, start + t1r * NS)
                for a in range(start + t0r * NS, hi, slab_tiles * NS):
                    tiles = pack_slab(a, min(a + slab_tiles * NS, hi), L, NS)[0]
                    t0 = (a - start) // NS
                    f.seek(offset + t0 * L * NS)
                    f.write(np.ascontiguousarray(tiles).data)
                    if pk_mm is not None:
                        e_pack(tiles, out=pk_mm[t0 : t0 + len(tiles)])
            del pk_mm
            offset += T * L * NS
    z = np.load(path)
    arrays = {k: z[k] for k in z.files}
    for i, (h, r) in enumerate(zip(have, req)):
        arrays[f"b{i}_ranges"] = np.asarray(
            _norm_ranges(list(h) + list(r), Ts[i]), np.int64).reshape(-1, 2)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fm:
        np.savez(fm, **arrays)
    os.replace(tmp, path)
    if sc_fresh:
        # The sidecar's claims grow by the rows written here; its own
        # ranges may be narrower than the store's.
        man_path = os.path.join(path + ".pack5", "manifest.json")
        try:
            with open(man_path) as mf:
                sc_have = json.load(mf).get("ranges")
            sc_have = (_full_ranges(Ts) if sc_have is None
                       else [_norm_ranges([tuple(x) for x in r], T) for r, T in zip(sc_have, Ts)])
            union = [_norm_ranges(list(h) + list(m), T) for h, m, T in zip(sc_have, missing, Ts)]
            _write_manifest(path + ".pack5", stream_manifest(
                stream_codec, pad_code, n, nchars, layout, ranges=union))
        except (OSError, ValueError):
            pass  # stale claims under-report; the next check rebuilds
    out = load_packed(path, n, nchars, expect_pad=pad_code, need_ranges=req)
    if stream_codec is not None and not sc_fresh and out is not None:
        # No sidecar of this layout: build it whole (rows a partial store
        # lacks pack as zeros, which no shard of this process reads).
        build_stream_sidecar(out, path, stream_codec, pad_code=pad_code, slab_tiles=slab_tiles)
    return out


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


if os.environ.get(TUNING_ENV):
    apply_tuning(os.environ[TUNING_ENV])
