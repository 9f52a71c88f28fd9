"""Multi-device database sharding and the top-N merge (the port's
counterpart of cudasw4_tpu/parallel/sharding.py).

The reference CUDASW++4.0 splits each length partition over its GPUs and
merges per-GPU top-k lists on one of them (src/cudasw4.cuh:928-1004,
1362-1463).  The JAX package shards every bucket's tile axis over a 1-D
mesh and runs one shard_map program: per-shard scoring and top-k, an
all_gather of k candidates a shard, and a final sort.  Here:

- a ``Mesh`` is an ordered list of shards, each a device; a device may
  repeat (two shards on one card).  Each process holds the shards at its
  positions (``Mesh.local``); processes join through a
  ``torch.distributed`` group (``multihost.py``);
- every bucket's tiles split into ndev contiguous slices of ceil(T / ndev)
  tiles (``shard_ranges``), the JAX package's assignment.  The last
  slices are shorter where the JAX package pads them with tiles that score
  nothing: its programs need equal shapes, the kernels here take any tile
  count, and a shard that holds no tile of a bucket launches nothing for
  it;
- each shard's work is enqueued under its device and its own stream
  (``shard_context``), every shard's before any result is read, so that
  the devices, or two shards on one card, run together;
- a shard reduces its slots to its top N (``top_n``: descending score,
  then ascending slot, which within a shard is ascending id) and starts
  the copy of those candidates to the host (``Candidates``); across
  processes only these k candidates a shard and query travel
  (``Mesh.gather``); the merge sorts them by (-score, id) (``merge_topk``),
  since shard order is not id order once there is more than one bucket.

Spans (``utils.profiling.span``, mesh paths only): ``sw:shard <pos>``
around each shard's enqueue (``shard_span``), ``sw:shard_wait`` around the
host's waits for the shards' candidates and ``sw:merge`` around their merge
(``Candidates``).  Each local shard counts, at placement, the tiles, the
padded slots (tiles x NS x L) and the real residues it scores in a pass
(``count_load``; ``SearchEngine.shard_load``).

The counterparts of the JAX package's ``build_sharded_*`` functions:
``build_sharded_scan`` (and its chunked twin, whose per-shard body is the
port's single-device carry path),
``build_sharded_batch_scan`` and ``build_sharded_overflow_rescore`` are the
engine's mesh dispatches (engine.py), which enqueue each shard's kernels
through the single-device wrappers; the streamed-chunk scorers and
``build_sharded_chunk_candidates`` are the streamed pass's per-shard chunk
loop (engine_streaming.py).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import cuda_lib
from ..utils.profiling import span


class Mesh:
    """An ordered list of shards, each a device (the counterpart of a 1-D
    ``jax.sharding.Mesh``).  ``local``: the positions this process holds
    (all of them in one process); ``group``: the ``torch.distributed``
    process group the processes exchange candidates over, or None."""

    def __init__(self, devices, local=None, group=None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.local = tuple(range(len(self.devices))) if local is None else tuple(local)
        self.group = group

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local_devices(self) -> list:
        return [self.devices[p] for p in self.local]

    @property
    def multiprocess(self) -> bool:
        """Whether other processes hold some of the shards."""
        return len(self.local) < len(self.devices)

    def gather(self, arr: np.ndarray) -> np.ndarray:
        """Every process's per-local-shard array [len(local), ...], stacked
        in shard order: [size, ...] (the array itself without a group).
        Each process calls it in the same order with the same shape: NCCL
        gathers on the first local device, gloo on the host."""
        arr = np.ascontiguousarray(arr)
        if self.group is None:
            return arr
        import torch.distributed as dist

        t = torch.from_numpy(arr)
        world = dist.get_world_size(self.group)
        if dist.get_backend(self.group) == "nccl":
            t = t.to(self.local_devices[0])
            out = t.new_empty((world * t.shape[0], *t.shape[1:]))
            dist.all_gather_into_tensor(out, t, group=self.group)
            return out.cpu().numpy()
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts).numpy()


def _mesh_device(d) -> torch.device:
    """A shard's device: a CUDA device gets its index (the current one when
    it names none); CUDA without a card raises."""
    d = torch.device(d)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; name CPU devices for a mesh on the CPU")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices=None) -> Mesh:
    """A mesh over ``devices`` (default: every visible CUDA device; with
    none, it raises).  A device may repeat: ``["cuda:0", "cuda:0"]`` is two
    shards on one card, ``["cpu"] * n`` n shards on the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for a mesh; pass devices (e.g. ['cpu'] * 2)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh([_mesh_device(d) for d in devices])


def shard_ranges(T: int, ndev: int) -> list[tuple[int, int]]:
    """Tile range [a, b) of each of ``ndev`` shards in a run of T tiles:
    contiguous slices of ceil(T / ndev), the last ones shorter or empty
    (the JAX package's ``pad_tiles_for_mesh`` split, less its pad tiles)."""
    tl = -(-T // ndev)
    return [(min(d * tl, T), min((d + 1) * tl, T)) for d in range(ndev)]


@dataclass
class Shard:
    """One local shard: its position in the mesh, device, stream (None on
    the CPU), the substitution matrix on its device and, for a resident
    database, its slice of each bucket."""

    pos: int
    device: torch.device
    matrix: torch.Tensor
    stream: object = None
    #: Per bucket: the shard's tiles on its device, None where it holds none.
    tiles: list = field(default_factory=list)
    #: Per bucket: the index of the shard's first tile in the bucket.
    first: list = field(default_factory=list)
    #: Per bucket: the subject lengths of the shard's col tiles (``tiles``)
    #: on its device (``sw_col.ColLengths``), None for another kind or
    #: where it holds none.
    lengths: list = field(default_factory=list)
    #: Per bucket of a streamed database: the subject lengths of every
    #: tile of a col bucket on the shard's device, of which each chunk's
    #: slice takes a view; None for another kind.
    stream_lengths: list = field(default_factory=list)
    #: int64 reference id of each of the shard's slots, in slot order; -1
    #: for padding.
    ids: torch.Tensor | None = None
    #: What the shard scores in a pass (``count_load``): tiles, padded
    #: slots (tiles x NS x L) and real residues.
    num_tiles: int = 0
    slots: int = 0
    residues: int = 0


def make_shards(mesh: Mesh, matrix_flat: np.ndarray) -> list[Shard]:
    """A Shard for each local position: its stream and matrix (no tiles)."""
    shards = []
    for pos, dev in zip(mesh.local, mesh.local_devices):
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        sh = Shard(pos=pos, device=dev, matrix=torch.empty(0), stream=stream)
        with shard_context(sh):
            sh.matrix = cuda_lib.device_matrix(matrix_flat, dev)
        shards.append(sh)
    return shards


@contextlib.contextmanager
def shard_context(shard: Shard):
    """Work enqueued in the block goes to the shard's device and stream."""
    if shard.stream is None:
        yield
        return
    with torch.cuda.device(shard.device), torch.cuda.stream(shard.stream):
        yield


@contextlib.contextmanager
def shard_span(shard: Shard):
    """``shard_context`` inside the span ``sw:shard <pos>``: one shard's
    enqueue of a scan, a batch, a re-score or a streamed chunk."""
    with span(f"sw:shard {shard.pos}", shard.device), shard_context(shard):
        yield


def count_load(packed, shards: list[Shard], ndev: int, chunk_tiles=None) -> None:
    """Set each local shard's ``num_tiles``, ``slots`` and ``residues``:
    its ``shard_ranges`` slice of every bucket, or with ``chunk_tiles(b)``
    of every chunk of that many tiles (a streamed pass, the resident
    prefix's chunks included)."""
    for sh in shards:
        sh.num_tiles = sh.slots = sh.residues = 0
    for b in packed.buckets:
        T = b.num_tiles
        ct = max(1, T if chunk_tiles is None else chunk_tiles(b))
        for t0 in range(0, T, ct):
            split = shard_ranges(min(ct, T - t0), ndev)
            for sh in shards:
                a, e = split[sh.pos]
                sh.num_tiles += e - a
                sh.slots += (e - a) * b.NS * b.L
                sh.residues += int(b.lengths[t0 + a : t0 + e].sum(dtype=np.int64))


def shard_bucket_arrays(packed, shards: list[Shard], ndev: int) -> None:
    """Upload each local shard's slice of every bucket (``shard_ranges``),
    the subject lengths of its col tiles and its slots' ids, on the
    shard's stream.  A slice of a disk-backed store reads only its own
    tiles."""
    from ..engine_streaming import upload
    from ..ops.sw_col import ColLengths

    for sh in shards:
        tiles, first, lengths, ids = [], [], [], [np.zeros(0, np.int64)]
        with shard_context(sh):
            for b in packed.buckets:
                a, e = shard_ranges(b.num_tiles, ndev)[sh.pos]
                first.append(a)
                tiles.append(upload(b.tiles[a:e], sh.device) if e > a else None)
                lengths.append(ColLengths.place(b.lengths[a:e], sh.device)
                               if e > a and b.kernel == "col" else None)
                ids.append(np.asarray(b.seq_index[a:e], np.int64).reshape(-1))
            sh.tiles, sh.first, sh.lengths = tiles, first, lengths
            sh.ids = torch.as_tensor(np.concatenate(ids)).to(sh.device)
    count_load(packed, shards, ndev)


def top_n(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Top ``max(1, k)`` slots of each row of ``scores`` ([N] or [S, N]) by
    descending score, then ascending slot: one int64 key per slot,
    (score + 1) << 32 | (2^32 - 1 - slot), so the order is total and needs
    no tie rule from topk (the per-shard reduction of the JAX package's
    ``_shard_candidates``).  ``ids``: int64 [N] reference id of each slot,
    -1 for padding.  Returns (scores, ids) int64 on the scores' device; the
    padding slots that make up a short row come out as (-1, -1)."""
    n = scores.shape[-1]
    if n == 0:
        empty = torch.zeros(scores.shape, dtype=torch.int64, device=scores.device)
        return empty, empty
    s = torch.where(ids >= 0, scores.long(), -1) + 1
    slot = torch.arange(n, dtype=torch.int64, device=scores.device)
    key = (s << 32) | ((1 << 32) - 1 - slot)
    top = torch.topk(key, min(max(1, k), n), dim=-1).values
    slots = (1 << 32) - 1 - (top & ((1 << 32) - 1))
    return (top >> 32) - 1, ids[slots]


def merge_topk(vals: np.ndarray, ids: np.ndarray, k: int):
    """Merge candidates [S, rows, c] (S shards, or chunks) into each row's
    top ``max(1, k)`` by descending score, then ascending id; ids < 0 are
    padding.  Returns (scores, ids) int64 [rows, max(1, k)], short rows
    padded with -1 (the final sort of the JAX package's ``_merge_topk``)."""
    k = max(1, k)
    rows = vals.shape[1]
    out_v = np.full((rows, k), -1, np.int64)
    out_i = np.full((rows, k), -1, np.int64)
    for r in range(rows):
        v, i = vals[:, r].reshape(-1), ids[:, r].reshape(-1)
        keep = i >= 0
        v, i = v[keep], i[keep]
        order = np.lexsort((i, -v))[:k]
        out_v[r, : len(order)], out_i[r, : len(order)] = v[order], i[order]
    return out_v, out_i


class Candidates:
    """The top-N candidates of one launch on each local shard, on their way
    to the host.  ``add`` (under the shard's ``shard_context``, after its
    kernels are enqueued) starts the copies of its (scores, ids) [rows, c]
    and of any ``extras`` without blocking, and records an event on the
    shard's stream; ``host`` waits for them and reduces a shard's rows to
    its top N where c is larger (a streamed pass's chunks), its waits in
    the span ``sw:shard_wait``; ``merged`` gathers every process's shards
    and merges them (``merge_topk``) in the span ``sw:merge``."""

    def __init__(self, mesh: Mesh, k: int, rows: int):
        self.mesh, self.k, self.rows = mesh, max(1, k), rows
        self.parts: list = []

    def add(self, shard: Shard, vals, ids, extras=()) -> None:
        event = None
        if shard.stream is not None:
            vals, ids = vals.to("cpu", non_blocking=True), ids.to("cpu", non_blocking=True)
            extras = [t.to("cpu", non_blocking=True) for t in extras]
            event = torch.cuda.Event()
            event.record(shard.stream)
        self.parts.append((event, vals, ids, list(extras)))

    def host(self):
        """(scores [len(local), rows, k], ids, extras per shard) on the host,
        short rows padded with -1."""
        V = np.full((len(self.parts), self.rows, self.k), -1, np.int64)
        ids = V.copy()
        extras = []
        with span("sw:shard_wait", self.mesh.local_devices[0]):
            for event, *_ in self.parts:
                if event is not None:
                    event.synchronize()
        for j, (_, v, i, ex) in enumerate(self.parts):
            v, i = v.numpy().reshape(self.rows, -1), i.numpy().reshape(self.rows, -1)
            if v.shape[1] > self.k:  # a streamed pass: every chunk's top N
                v, i = merge_topk(v[None], i[None], self.k)
            V[j, :, : v.shape[1]], ids[j, :, : i.shape[1]] = v, i
            extras.append([t.numpy() for t in ex])
        return V, ids, extras

    def merged(self, host=None):
        """Each row's global top N (``merge_topk`` over every shard)."""
        V, ids, _ = self.host() if host is None else host
        V, ids = self.mesh.gather(V), self.mesh.gather(ids)
        with span("sw:merge", self.mesh.local_devices[0]):
            return merge_topk(V, ids, self.k)
