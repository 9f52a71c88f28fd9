"""Build and load the port's CUDA kernels (``csrc/*.cu``) through ctypes.

The library compiles with ``nvcc`` for ``sm_90a`` into
``build/kernels/`` at the repository root, at first use, under a name
keyed by a hash of the sources, the headers, the flags and the units, so a
fresh checkout builds once and an edited source rebuilds.  It is several
units (``UNITS``: the dispatch, the col kernels, and the cell group
kernels once a slice of their (G, R) instances), compiled with
``-c`` in a pool of ``os.cpu_count()`` processes and linked once with
``-shared``; object files and the library are written under temporary
names and renamed, so processes that build at once never read half a
file.  Nothing compiles when a module is imported: the CPU paths never
call ``lib()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)
#: Slices of the cell group kernels' (G, R) instances, one unit each
#: (``CELL_SLICES`` in csrc/sw_cell.cuh, which names as many).
CELL_SLICES = 8
#: The library's units: (source, extra flags), one object each.
UNITS = (
    ("sw_tiles.cu", ()),
    ("sw_col.cu", ()),
    *(("sw_cell_unit.cu", (f"-DSW_SLICE={k}",)) for k in range(CELL_SLICES)),
)

_P = ctypes.c_void_p
_I = ctypes.c_int
#: The launch function of the row kernel, with one signature: tiles,
#: query, mat, A, T, L, NS, nrows, gop, gex, th, te, out, sat, stream
#: (sat must be 0: the row kernel is exact only; th and te are the col
#: route's per-warp boundary columns, ``launch_row``).
LAUNCHES = {"sw_row_kernel": "sw_row_launch"}
_SIGNATURE = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P]
#: The launch function of the cell group kernel (B1 and B4 in both state
#: modes, ``sw_cell16_kernel``), with a fifth signature: tiles, queries,
#: rows, mat, A, T, L, S, W, gop, gex, G, R, out, stream (``launch_cell``).
CELL_LAUNCHES = {"sw_cell16_kernel": "sw_cell_launch"}
_CELL_SIGNATURE = [_P] * 4 + [_I] * 9 + [_P, _P]
#: The launch function of the col wavefront kernels (B3, B5 and B6 in
#: both state modes; col flat when rows is non-null, col fused when rows
#: is null and offs holds the gapless starts), with a fourth signature:
#: tiles, queries, rows, offs, mat, A, T, L, S, W, rtot, gop, gex, hin,
#: fin, hout, fout, th, te, out, sat, lens, stream; th and te are the
#: per-warp boundary columns, lens the subjects' lengths or null
#: (``launch_col``).
COL_LAUNCHES = {
    "sw_col_kernel": "sw_col_launch",
    "sw_col_flat_kernel": "sw_col_launch",
    "sw_col_fused_kernel": "sw_col_launch",
}
_COL_SIGNATURE = [_P] * 5 + [_I] * 8 + [_P] * 7 + [_I, _P, _P]
#: The launch functions of the tool kernels (B7 in both state modes, B8),
#: with a third signature: tiles, query, mat, A, T, L, nrows, gop, gex, G,
#: R, sat, arg, out, stream; arg is the pair kernel's tiles per block and 0
#: for the manual kernel (``launch_tool``).
TOOL_LAUNCHES = {
    "sw_manual_kernel": "sw_cell_manual_launch",
    "sw_pair_kernel": "sw_cell_pair_launch",
}
_TOOL_SIGNATURE = [_P] * 3 + [_I] * 10 + [_P, _P]

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot build")
    return found


def _sources() -> list[Path]:
    """Every source and header of the library, in a fixed order."""
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(repr(UNITS).encode())
    return BUILD_DIR / f"libsw_tiles_{h.hexdigest()[:16]}.so"


def object_dir() -> Path:
    """Where the units' objects of ``library_path()`` go."""
    return library_path().with_suffix(".o.d")


def _run(cmd) -> None:
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {res.returncode}:\n{' '.join(cmd)}\n"
            f"{res.stdout}{res.stderr}"
        )


def _compile(nvcc: str, unit: int, objects: Path) -> Path:
    """Compile unit ``unit`` of UNITS into ``objects`` (kept when present:
    it is keyed by the same hash as the library)."""
    src, flags = UNITS[unit]
    obj = objects / f"unit{unit}.o"
    if not obj.exists():
        tmp = obj.with_name(f"{obj.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        _run([nvcc, *NVCC_FLAGS, *flags, "-c", "-o", str(tmp), str(CSRC / src)])
        os.replace(tmp, obj)  # atomic: a concurrent build never sees half a file
    return obj


def build() -> Path:
    """Compile the kernel library if it is not built yet; returns its path.
    The units compile in parallel, one process a CPU core."""
    out = library_path()
    if out.exists():
        return out
    objects = object_dir()
    objects.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with ThreadPoolExecutor(max_workers=build_jobs()) as pool:
        futures = [pool.submit(_compile, nvcc, k, objects) for k in range(len(UNITS))]
        objs = [f.result() for f in futures]  # raises the first failed unit's error
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    _run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)])
    os.replace(tmp, out)
    return out


def build_jobs() -> int:
    """nvcc processes a build runs at once: one a CPU core, at most one a
    unit."""
    return min(len(UNITS), os.cpu_count() or 1)


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for names, sig in ((LAUNCHES, _SIGNATURE), (CELL_LAUNCHES, _CELL_SIGNATURE),
                               (COL_LAUNCHES, _COL_SIGNATURE),
                               (TOOL_LAUNCHES, _TOOL_SIGNATURE)):
                for name in names.values():
                    fn = getattr(handle, name)
                    fn.argtypes = sig
                    fn.restype = ctypes.c_int
            handle.sw_col_pass_columns.argtypes = []
            handle.sw_col_pass_columns.restype = ctypes.c_int
            handle.sw_cell_shapes.argtypes = [_P, _I]
            handle.sw_cell_shapes.restype = ctypes.c_int
            handle.sw_error_string.argtypes = [ctypes.c_int]
            handle.sw_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def check_launch(code: int, name: str) -> None:
    """Raise if a launch function reported a CUDA error."""
    if code != 0:
        msg = lib().sw_error_string(code).decode()
        raise RuntimeError(f"{name} failed to launch: CUDA error {code} ({msg})")


def to_device(array, device: torch.device) -> torch.Tensor:
    """Copy a host array to ``device`` without blocking the host: through
    pinned memory on CUDA, so a launch never waits for queued kernels."""
    t = torch.as_tensor(array)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int, device) -> None:
    """Validate a kernel argument: device, dtype, rank and contiguity."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def alphabet_dim(matrix_flat: torch.Tensor) -> int:
    """Alphabet size A of a flattened [A*A] substitution matrix."""
    n = matrix_flat.numel()
    a = int(round(n ** 0.5))
    if a * a != n or a > 26:
        raise ValueError(f"substitution matrix of {n} entries is not A*A with A <= 26")
    return a


def device_matrix(matrix_flat: np.ndarray, device) -> torch.Tensor:
    """A flattened substitution matrix on ``device`` (int32), its entries'
    (min, max) noted from the host array (``matrix_range``).  The note is
    an attribute of this tensor: a copy (``.to``, ``.contiguous``) drops
    it, so place the matrix with this, and launch with what it returns."""
    host = np.asarray(matrix_flat, dtype=np.int32).reshape(-1)
    t = torch.as_tensor(host).to(device)
    t.score_range = (int(host.min()), int(host.max()))
    return t


def matrix_range(matrix_flat: torch.Tensor) -> tuple[int, int]:
    """(min, max) of a substitution matrix's entries: the range noted when
    it was placed (``device_matrix``), else read from the tensor once (a
    device tensor: one synchronisation) and noted on it."""
    rng = getattr(matrix_flat, "score_range", None)
    if rng is None:
        rng = (int(matrix_flat.min()), int(matrix_flat.max()))
        matrix_flat.score_range = rng
    return rng


def cell16_bmax(L: int, nrows: int, gop: int, gex: int) -> int:
    """The host's copy of csrc/sw_cell.cuh ``cell16_bmax``: the largest
    substitution score with which s16x2 lanes cannot wrap over ``nrows``
    query rows and L columns (every H at most min(L, nrows) x max B <=
    32767, at most 16383); -8193 where a gap lies outside [-8192, 0]."""
    if gop > 0 or gex > 0 or gop < -8192 or gex < -8192:
        return -8193
    return min(32767 // max(min(L, nrows), 1), 16383)


def cell16_fits(L: int, nrows: int, gop: int, gex: int, lo: int, hi: int) -> bool:
    """Whether ``sw_cell16_kernel`` scores a slot of ``nrows`` rows against
    tiles of L columns in s16x2 lanes (the fit each block proves), for a
    matrix of entries in [lo, hi]; else it runs the slot in int32 lanes."""
    return lo >= -8192 and hi <= cell16_bmax(L, nrows, gop, gex)


def count(wrapper, exact: bool, plain: bool = False) -> None:
    """Add one to a wrapper's counter of its mode: ``launches`` or
    ``plain_calls`` for exact int32 state, ``launches16`` or
    ``plain_calls16`` for int16 state."""
    name = ("plain_calls" if plain else "launches") + ("" if exact else "16")
    setattr(wrapper, name, getattr(wrapper, name) + 1)


def check_sat(sat: int) -> int:
    """The int16 ceiling as the kernels take it: 0 < sat <= 32767."""
    sat = int(sat)
    if not 0 < sat <= 32767:
        raise ValueError(f"int16 state needs 0 < SAT <= 32767, got {sat}")
    return sat


def check_query_rows(query, nrows: int, dev) -> None:
    """Validate a 1-D int32 query block on ``dev`` holding ``nrows`` rows."""
    require(query, "query", torch.int32, 1, dev)
    if not 0 <= nrows <= query.numel():
        raise ValueError(f"{nrows} query rows outside the query block of {query.numel()}")


def launch_row(wrapper, tiles, query, matrix_flat, nrows: int, gop: int, gex: int,
               pool: bool):
    """Launch the row kernel (``sw_row_kernel``, LAUNCHES) on the tiles'
    device and stream, and count the launch on ``wrapper.launches``.

    ``tiles``: int8 [T, L, NS]; ``query``: int32, ``nrows`` real rows.
    Allocates the f32 scores [T, NS] and, with ``pool`` (the col route,
    ``sw_row.row_route``), the int32 boundary columns [T * NS, nrows] x 2;
    the cell route takes no scratch.  Raises if the launch reports an
    error.  Never synchronises.
    """
    dev = tiles.device
    require(tiles, "tiles", torch.int8, 3, dev)
    require(matrix_flat, "matrix_flat", torch.int32, 1, dev)
    A = alphabet_dim(matrix_flat)
    check_query_rows(query, nrows, dev)
    T, L, NS = tiles.shape
    out = torch.empty((T, NS), dtype=torch.float32, device=dev)
    th = te = None
    if pool and nrows > 0:
        th = torch.empty((T * NS, nrows), dtype=torch.int32, device=dev)
        te = torch.empty_like(th)
    with torch.cuda.device(dev):
        code = lib().sw_row_launch(
            tiles.data_ptr(), query.data_ptr(), matrix_flat.data_ptr(), A, T, L, NS, nrows,
            gop, gex, None if th is None else th.data_ptr(),
            None if te is None else te.data_ptr(), out.data_ptr(), 0, stream_handle(dev),
        )
    check_launch(code, "sw_row_kernel")
    count(wrapper, True)
    return out


def cell_shapes() -> list[tuple[int, int]]:
    """The (G, R) instances the kernel library was built with."""
    buf = (ctypes.c_int * 256)()
    n = lib().sw_cell_shapes(ctypes.cast(buf, ctypes.c_void_p), len(buf))
    return [(buf[2 * k], buf[2 * k + 1]) for k in range(n)]


def launch_cell(wrapper, tiles, queries, matrix_flat, gop: int, gex: int, rows, shape,
                sat: int = 0):
    """Launch the cell group kernel ``sw_cell16_kernel`` at the instance
    ``shape`` = (G, R) on the tiles' device and stream, and count the
    launch on the wrapper (``count``): in ``launches16`` for ``sat`` > 0
    (int16 state), else in ``launches``.

    ``tiles``: int8 [T, L, 32, 128]; ``queries``: int32 [S, W].
    ``rows``: an int, the one query's rows (S = 1, B1), or host ints, the
    slots' row counts (B4), copied to the device without blocking.  The
    scores are exact in both state modes (each block proves its fit, or
    runs in int32 lanes).  An exact launch also counts its slots
    (``count_slots``) by the matrix's range (``matrix_range``): noted on a
    matrix that ``device_matrix`` placed, else read from the card once, on
    the first exact launch with that tensor (one synchronisation).
    Allocates only the f32 scores [S, T, 4096]: the kernel keeps the DP in
    registers.
    Raises if the launch reports an error.
    """
    dev = tiles.device
    require(tiles, "tiles", torch.int8, 4, dev)
    require(queries, "queries", torch.int32, 2, dev)
    require(matrix_flat, "matrix_flat", torch.int32, 1, dev)
    A = alphabet_dim(matrix_flat)
    T, L = tiles.shape[0], tiles.shape[1]
    S, W = queries.shape
    rows_dev = None
    if isinstance(rows, int):
        if S != 1 or rows != W:
            raise ValueError(f"one query of {rows} rows, got a block of {tuple(queries.shape)}")
    else:
        rows_dev = to_device(np.asarray(rows, dtype=np.int32), dev)
    out = torch.empty((S, T, math.prod(tiles.shape[2:])), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = lib().sw_cell_launch(
            tiles.data_ptr(), queries.data_ptr(),
            None if rows_dev is None else rows_dev.data_ptr(), matrix_flat.data_ptr(),
            A, T, L, S, W, gop, gex, *shape, out.data_ptr(), stream_handle(dev),
        )
    check_launch(code, "sw_cell16_kernel")
    count(wrapper, not sat)
    if not sat:
        slots = [W] if rows_dev is None else [int(n) for n in rows if n > 0]
        count_slots(wrapper, L, slots, gop, gex, matrix_range(matrix_flat))
    return out


def count_slots(wrapper, L: int, slots, gop: int, gex: int, score_range) -> None:
    """Count an exact cell launch's slots (their row counts: a B1 launch's
    one, a B4 launch's of rows > 0) on the wrapper: ``s16x2_slots``, those
    that ``sw_cell16_kernel`` scores in s16x2 lanes (``cell16_fits``), and
    ``int32_slots``, the rest, whose blocks run int32 lanes."""
    n16 = sum(cell16_fits(L, n, gop, gex, *score_range) for n in slots)
    wrapper.s16x2_slots += n16
    wrapper.int32_slots += len(slots) - n16


#: Device-memory budget for one tile group's temporaries: the col carry
#: (bottom-row H and F, 8 bytes per tile char) and the col wavefront's
#: boundary columns (H and E of each subject per query row).  Buckets whose
#: temporaries would exceed it run one tile group at a time
#: (``sw_col.col_group_tiles``, ``sw_row.row_route``).
TEMP_BYTES = 1 << 30


def col_boundary_bytes(T: int, rows: int, sat: int = 0, ns: int = 4096) -> int:
    """Device bytes of a col wavefront launch's boundary columns: H and E
    for each of the T x ``ns`` warps' ``rows`` pool rows, int32 (int16
    under ``sat``)."""
    return 2 * T * ns * rows * (2 if sat else 4)


def launch_col(wrapper, kernel: str, tiles, queries, matrix_flat, gop: int, gex: int,
               slots=None, state_in=None, emit_state: bool = False, sat: int = 0,
               lengths=None):
    """Launch the col kernel ``kernel`` (a key of COL_LAUNCHES) on the
    tiles' device and stream, and count the launch on the wrapper
    (``count``).

    ``tiles``: int8 [T, L, 32, 128]; ``queries``: int32 [S, W].  ``slots``:
    None for the col kernel (one slot running all W rows); host ints
    (rows, offs, rtot) for col flat: slot s runs rows[s] rows, its boundary
    columns at pool rows offs[s] .. of rtot; or (None, starts, rtot) for
    col fused: slot s runs rows starts[s] .. starts[s + 1] of a gapless
    pool of rtot = starts[S] rows.  ``state_in``: int32 (hrow,
    frow) shaped as ``tiles``, the row above the first query row;
    ``emit_state``: also return the last row's (H, F), int32 (clamped at
    ``sat`` under int16 state).  ``lengths``: int32 [T, 4096], the
    subjects' lengths, each warp then running only its own subject's
    passes (the carry out unspecified past them), or None for every warp
    running all L.  Allocates the f32 scores [S, T, 4096] and,
    when L spans more than one pass, the boundary columns
    (``col_boundary_bytes``); raises if the launch reports an error.
    Returns (scores, (hout, fout) or None).  Never synchronises.
    """
    dev = tiles.device
    require(tiles, "tiles", torch.int8, 4, dev)
    require(queries, "queries", torch.int32, 2, dev)
    require(matrix_flat, "matrix_flat", torch.int32, 1, dev)
    A = alphabet_dim(matrix_flat)
    T, L = tiles.shape[0], tiles.shape[1]
    S, W = queries.shape
    rows_dev = offs_dev = None
    rtot = W
    if slots is not None:
        rows, offs, rtot = slots
        if rows is not None:
            rows_dev = to_device(np.asarray(rows, dtype=np.int32), dev)
        offs_dev = to_device(np.asarray(offs, dtype=np.int32), dev)
    hin = fin = None
    if state_in is not None:
        for name, t in zip(("hrow", "frow"), state_in):
            require(t, name, torch.int32, 4, dev)
            if t.shape != tiles.shape:
                raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(tiles.shape)}")
        hin, fin = state_in[0].data_ptr(), state_in[1].data_ptr()
    if lengths is not None:
        require(lengths, "lengths", torch.int32, 2, dev)
        if lengths.shape != (T, math.prod(tiles.shape[2:])):
            raise ValueError(f"lengths has shape {tuple(lengths.shape)}, expected "
                             f"{(T, math.prod(tiles.shape[2:]))}")
    out = torch.empty((S, T, math.prod(tiles.shape[2:])), dtype=torch.float32, device=dev)
    state = None
    if emit_state:
        state = (torch.empty(tiles.shape, dtype=torch.int32, device=dev),
                 torch.empty(tiles.shape, dtype=torch.int32, device=dev))
    th = te = None
    if L > lib().sw_col_pass_columns() and rtot > 0:
        th = torch.empty((T * 4096, rtot), dtype=torch.int16 if sat else torch.int32, device=dev)
        te = torch.empty_like(th)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        code = getattr(lib(), COL_LAUNCHES[kernel])(
            tiles.data_ptr(), queries.data_ptr(), ptr(rows_dev), ptr(offs_dev),
            matrix_flat.data_ptr(), A, T, L, S, W, rtot, gop, gex, hin, fin,
            *(ptr(t) for t in state or (None, None)), ptr(th), ptr(te), out.data_ptr(), sat,
            ptr(lengths), stream_handle(dev),
        )
    check_launch(code, kernel)
    count(wrapper, not sat)
    return out, state


def launch_tool(wrapper, kernel: str, tiles, query, matrix_flat, params, shape, sat: int,
                arg: int):
    """Launch the tool kernel ``kernel`` (a key of TOOL_LAUNCHES) at the
    cell instance ``shape`` = (G, R) on cell tiles [T, L, 32, 128] on their
    device and stream, and count the launch on the wrapper (``count``).

    ``query``: int32, ``params[0]`` real rows (gop, gex next); ``arg``: see
    TOOL_LAUNCHES.  Allocates only the f32 scores [T, 4096]: the kernels
    keep the DP in registers.  Raises if the launch reports an error.
    Never synchronises.
    """
    dev = tiles.device
    require(tiles, "tiles", torch.int8, 4, dev)
    require(matrix_flat, "matrix_flat", torch.int32, 1, dev)
    A = alphabet_dim(matrix_flat)
    nrows, gop, gex = int(params[0]), int(params[1]), int(params[2])
    check_query_rows(query, nrows, dev)
    out = torch.empty((tiles.shape[0], math.prod(tiles.shape[2:])), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        code = getattr(lib(), TOOL_LAUNCHES[kernel])(
            tiles.data_ptr(), query.data_ptr(), matrix_flat.data_ptr(),
            A, tiles.shape[0], tiles.shape[1], nrows, gop, gex, *shape, sat, arg,
            out.data_ptr(), stream_handle(dev),
        )
    check_launch(code, kernel)
    count(wrapper, not sat)
    return out
