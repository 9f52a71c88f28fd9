"""Build and load the port's CUDA kernels (``csrc/*.cu``) through ctypes.

The library compiles with ``nvcc`` for ``sm_90a`` into
``build/kernels/`` at the repository root, at first use, under a name
keyed by a hash of the sources and flags, so a fresh checkout builds once
and an edited source rebuilds.  Nothing compiles when a module is
imported: the CPU paths never call ``lib()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "sw_tiles.cu",)
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
#: The launch functions of the kernels, all with one signature:
#: tiles, query, mat, A, T, L, NS, nrows, gop, gex, hin, fin, hs, fs, out, stream.
LAUNCHES = {
    "sw_cell_kernel": "sw_cell_launch",
    "sw_row_kernel": "sw_row_launch",
    "sw_col_kernel": "sw_col_launch",
}
_SIGNATURE = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P]

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


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libsw_tiles_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel library if it is not built yet; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {res.returncode}:\n{res.stdout}{res.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name in LAUNCHES.values():
                fn = getattr(handle, name)
                fn.argtypes = _SIGNATURE
                fn.restype = ctypes.c_int
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


def launch(wrapper, kernel: str, tiles, query, matrix_flat, params, state_in=None):
    """Launch ``kernel`` (a key of LAUNCHES) on the tiles' device and stream,
    and count the launch on ``wrapper.launches``.

    Checks device, dtype, contiguity and that the ``params[0]`` query rows
    lie in the query block; allocates the f32 scores [T, NS] and the int32
    H/F scratch shaped as ``tiles``; raises if the launch reports an error.
    ``state_in``: (hrow, frow) shaped as ``tiles``, the row above the first
    query row.  Returns (scores, (hs, fs)): after the kernel the scratch
    holds the last query row's H and F.  Never synchronises.
    """
    dev = tiles.device
    require(tiles, "tiles", torch.int8, tiles.dim(), dev)
    require(query, "query", torch.int32, 1, dev)
    require(matrix_flat, "matrix_flat", torch.int32, 1, dev)
    A = alphabet_dim(matrix_flat)
    nrows, gop, gex = int(params[0]), int(params[1]), int(params[2])
    if not 0 <= nrows <= query.numel():
        raise ValueError(f"{nrows} query rows outside the query block of {query.numel()}")
    hin = fin = None
    if state_in is not None:
        for name, t in zip(("hrow", "frow"), state_in):
            require(t, name, torch.int32, tiles.dim(), dev)
            if t.shape != tiles.shape:
                raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(tiles.shape)}")
        hin, fin = state_in[0].data_ptr(), state_in[1].data_ptr()
    T, L = tiles.shape[0], tiles.shape[1]
    NS = math.prod(tiles.shape[2:])
    out = torch.empty((T, NS), dtype=torch.float32, device=dev)
    hs = torch.empty(tiles.shape, dtype=torch.int32, device=dev)
    fs = torch.empty_like(hs)
    with torch.cuda.device(dev):
        code = getattr(lib(), LAUNCHES[kernel])(
            tiles.data_ptr(), query.data_ptr(), matrix_flat.data_ptr(),
            A, T, L, NS, nrows, gop, gex, hin, fin,
            hs.data_ptr(), fs.data_ptr(), out.data_ptr(), stream_handle(dev),
        )
    check_launch(code, kernel)
    wrapper.launches += 1
    return out, (hs, fs)
