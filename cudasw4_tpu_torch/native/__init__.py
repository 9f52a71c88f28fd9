"""Native (C++) IO: the FASTA/FASTQ(.gz) parser, the tile packer and the
b32/b21 transfer packers of ``io.cpp``, through ctypes (the port's
counterpart of cudasw4_tpu/native/).

The library compiles with ``g++ ... -lz`` at first use into
``build/native/`` at the repository root, under a name keyed by a hash of
the source and the command, written under a temporary name and renamed, so
a fresh checkout builds once and concurrent processes never load half a
file.  Importing this module compiles nothing.  Every caller keeps its
Python path for where the library cannot build (no compiler, no zlib),
as in the JAX package; ``CUDASW4_TPU_TORCH_NATIVE=0`` switches the library
off.  ``build_error`` holds why the last attempt failed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..constants import UNKNOWN

#: Environment switch: "0" keeps every caller on its Python path.
NATIVE_ENV = "CUDASW4_TPU_TORCH_NATIVE"

SOURCE = Path(__file__).resolve().parent / "io.cpp"
BUILD_DIR = SOURCE.parent.parent.parent / "build" / "native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False
#: Why the library is unavailable after a failed build or load, else None.
build_error: str | None = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libtpusw_io_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    """Compile the library if it is not built yet; returns its path.
    Raises OSError or CalledProcessError when it cannot build."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp), "-lz"],
                   check=True, capture_output=True, text=True, timeout=300)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def _bind(lib) -> None:
    lib.tpusw_parse_fasta.restype = ctypes.c_void_p
    lib.tpusw_parse_fasta.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    for name in ("tpusw_num_sequences", "tpusw_num_chars", "tpusw_headers_size"):
        getattr(lib, name).restype = ctypes.c_int64
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.tpusw_chars.restype = ctypes.POINTER(ctypes.c_int8)
    lib.tpusw_offsets.restype = ctypes.POINTER(ctypes.c_int64)
    lib.tpusw_lengths.restype = ctypes.POINTER(ctypes.c_int32)
    lib.tpusw_headers.restype = ctypes.POINTER(ctypes.c_char)
    lib.tpusw_header_offsets.restype = ctypes.POINTER(ctypes.c_int64)
    for name in ("tpusw_chars", "tpusw_offsets", "tpusw_lengths", "tpusw_headers",
                 "tpusw_header_offsets", "tpusw_free_result"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.tpusw_free_result.restype = None
    lib.tpusw_stream_open.restype = ctypes.c_void_p
    lib.tpusw_stream_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.tpusw_stream_next.restype = ctypes.c_void_p
    lib.tpusw_stream_next.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
                                      ctypes.c_int]
    lib.tpusw_stream_close.restype = None
    lib.tpusw_stream_close.argtypes = [ctypes.c_void_p]
    for name in ("tpusw_pack_b32", "tpusw_pack_b21"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [
            np.ctypeslib.ndpointer(np.int8, flags="C"), ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32, flags="C,WRITEABLE"),
        ]
    lib.tpusw_pack_bucket.restype = None
    lib.tpusw_pack_bucket.argtypes = [
        np.ctypeslib.ndpointer(np.int8, flags="C"),
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        np.ctypeslib.ndpointer(np.int32, flags="C"),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int8, flags="C,WRITEABLE"),
        np.ctypeslib.ndpointer(np.int32, flags="C,WRITEABLE"),
        np.ctypeslib.ndpointer(np.int32, flags="C,WRITEABLE"),
        ctypes.c_int8,
    ]


def get_lib():
    """The loaded library (built on first call), or None when it is
    switched off (``CUDASW4_TPU_TORCH_NATIVE=0``) or cannot build or load
    (``build_error`` says why)."""
    global _lib, _tried, build_error
    if os.environ.get(NATIVE_ENV, "1") == "0":
        return None
    with _lock:
        if not _tried:
            _tried = True
            try:
                lib = ctypes.CDLL(str(_build()))
                _bind(lib)
                _lib = lib
            except subprocess.CalledProcessError as e:
                build_error = f"g++ failed with exit code {e.returncode}: {e.stderr}"
            except (OSError, subprocess.TimeoutExpired, AttributeError) as e:
                build_error = f"{type(e).__name__}: {e}"
        return _lib


def _result(lib, h, header_blob: bool):
    """(chars, offsets, lengths, headers) copied out of a native result."""
    n = lib.tpusw_num_sequences(h)
    nchars = lib.tpusw_num_chars(h)
    hsize = lib.tpusw_headers_size(h)
    # An empty native buffer has a null data pointer (no records, or every
    # sequence empty): as_array would raise on it.
    chars = (np.ctypeslib.as_array(lib.tpusw_chars(h), (nchars,)).copy()
             if nchars else np.zeros(0, np.int8))
    offsets = np.ctypeslib.as_array(lib.tpusw_offsets(h), (n + 1,)).copy()
    lengths = (np.ctypeslib.as_array(lib.tpusw_lengths(h), (n,)).copy()
               if n else np.zeros(0, np.int32))
    hoffs = np.ctypeslib.as_array(lib.tpusw_header_offsets(h), (n + 1,)).copy()
    hblob = ctypes.string_at(lib.tpusw_headers(h), hsize) if hsize else b""
    if header_blob:
        headers = (np.frombuffer(hblob, np.uint8).copy(), hoffs)
    else:
        headers = [hblob[int(hoffs[i]):int(hoffs[i + 1])] for i in range(n)]
    return np.asarray(chars, np.int8), offsets, lengths, headers


def parse_fasta_native(path: str, header_blob: bool = False):
    """Parse, encode and pad a FASTA/FASTQ(.gz) file natively.

    Returns (chars int8, offsets int64 [n + 1], lengths int32 [n], headers)
    or None when the library is unavailable; raises ValueError on a parse
    error (a missing file included).  ``headers``: a list of bytes, or with
    ``header_blob`` a (blob uint8, header_offsets int64 [n + 1]) pair."""
    lib = get_lib()
    if lib is None:
        return None
    errbuf = ctypes.create_string_buffer(512)
    h = lib.tpusw_parse_fasta(os.fsencode(path), errbuf, len(errbuf))
    if not h:
        raise ValueError(f"native FASTA parse failed: {errbuf.value.decode(errors='replace')}")
    try:
        return _result(lib, h, header_blob)
    finally:
        lib.tpusw_free_result(h)


def stream_fasta_native(path: str, chunk_chars: int = 256 << 20):
    """Yield (chars, offsets, lengths, headers list) batches of complete
    records of at least ``chunk_chars`` padded chars each (the last may be
    shorter).  Raises RuntimeError when the library is unavailable (check
    ``get_lib()`` first) and ValueError on a parse error."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native library is unavailable")
    errbuf = ctypes.create_string_buffer(512)
    st = lib.tpusw_stream_open(os.fsencode(path), errbuf, len(errbuf))
    if not st:
        raise ValueError(f"native FASTA open failed: {errbuf.value.decode(errors='replace')}")
    try:
        while True:
            h = lib.tpusw_stream_next(st, chunk_chars, errbuf, len(errbuf))
            if not h:
                if errbuf.value:
                    raise ValueError("native FASTA parse failed: "
                                     f"{errbuf.value.decode(errors='replace')}")
                return
            try:
                yield _result(lib, h, header_blob=False)
            finally:
                lib.tpusw_free_result(h)
    finally:
        lib.tpusw_stream_close(st)


def pack_codes_native(flat, out, codec: str) -> bool:
    """Transfer-pack one slab natively: ``flat`` int8 [rows, E] C-contiguous
    codes into ``out`` int32 [rows, W] (a C-contiguous buffer, a memmap
    slice too).  Returns False when the library is unavailable; raises
    ValueError on out-of-range codes (as the numpy path does)."""
    lib = get_lib()
    if lib is None:
        return False
    fn = lib.tpusw_pack_b32 if codec == "b32" else lib.tpusw_pack_b21
    if fn(flat, flat.shape[0], flat.shape[1], out) != 0:
        raise ValueError(f"transfer pack ({codec}): code out of range")
    return True


def pack_bucket_native(chars, offsets, lengths, start, stop, L, NS, pad=UNKNOWN):
    """Pack sequences [start, stop) into position-major row-layout tiles
    natively: (tiles int8 [T, L, NS], seq_index, seq_lengths int32
    [T, NS]), or None when the library is unavailable or NS is not a
    multiple of 64 (the packer's subject block).  ``pad`` fills the
    positions past each sequence."""
    lib = get_lib()
    if lib is None or NS % 64 != 0:
        return None
    T = -(-(stop - start) // NS)
    out = (np.empty((T, L, NS), np.int8), np.empty((T, NS), np.int32),
           np.empty((T, NS), np.int32))
    lib.tpusw_pack_bucket(
        np.ascontiguousarray(chars, dtype=np.int8), np.ascontiguousarray(offsets, dtype=np.int64),
        np.ascontiguousarray(lengths, dtype=np.int32), start, stop, L, NS, *out, pad,
    )
    return out
