"""Transfer packing: 6 or 7 residue codes per int32 word (the port's
counterpart of cudasw4_tpu/ops/pack5.py).

A streamed database crosses the host->device link once per batch of
queries, so the streamed chunks travel packed and unpack on the device
into the int8 tiles the kernels read.  Two codecs:

- ``b32`` (5-bit fields): 6 codes a word = 5.33 bits a residue, valid
  for any code 0..31 (the full-blosum alphabet too, pad 25); unpacks with
  shifts and masks.
- ``b21`` (base 21): 7 codes a word = 4.57 bits a residue (21^7 < 2^31),
  valid for the classic alphabet only (codes 0..20); unpacks with
  constant divisions by 21.

The packed words are bit-identical to the JAX package's for the same
tiles, so either package reads a sidecar that the other wrote.  The pack
runs in numpy on the host, slab by slab.  The unpack (``unpack5``,
``unpack21``) is torch ops on the packed tensor's device, as the JAX
package computes it in jnp ops outside any kernel; the ``*_np`` versions
are the host references.
"""

from __future__ import annotations

import numpy as np
import torch

#: Environment switch of the streamed chunks' codec (``choose_codec``):
#: "1" b32, the default; "2" b21; anything else raw bytes.
STREAM_PACK_ENV = "CUDASW4_TPU_TORCH_STREAM_PACK"

#: b32: codes per int32 word (5 bits each, bits 0..29; the top 2 bits stay
#: clear, so every word is non-negative).
CPW = 6

#: b21: codes per int32 word (21^7 = 1.80e9 < 2^31).
CPW21 = 7
BASE21 = 21


def words_for(elems: int) -> int:
    """int32 words per tile for ``elems`` int8 codes (b32)."""
    return -(-elems // CPW)


def words_for21(elems: int) -> int:
    """int32 words per tile for ``elems`` int8 codes (b21)."""
    return -(-elems // CPW21)


def _pack_slabs(tiles, out, cpw, max_code, combine, slab):
    """The slab loop of both codecs: range-check each slab (ValueError:
    an out-of-range code would corrupt a word silently), zero-pad it to a
    word boundary, group it into [rows, W, cpw] int32 and let ``combine``
    fold the code axis into words.  ``slab`` tiles at a time bound the
    temporaries; ``out`` may be any [T, W] int32 array (a memmap too),
    filled in place."""
    T = tiles.shape[0]
    E = int(np.prod(tiles.shape[1:]))
    W = -(-E // cpw)
    if out is None:
        out = np.empty((T, W), np.int32)
    for t0 in range(0, T, slab):
        t1 = min(t0 + slab, T)
        flat = np.ascontiguousarray(np.asarray(tiles[t0:t1]).reshape(t1 - t0, E))
        if flat.dtype != np.int8:
            raise ValueError("transfer pack requires int8 codes")
        if not (int(flat.min(initial=0)) >= 0 and int(flat.max(initial=0)) <= max_code):
            raise ValueError(f"transfer pack requires codes 0..{max_code}")
        if E != W * cpw:
            flat = np.concatenate([flat, np.zeros((t1 - t0, W * cpw - E), np.int8)], axis=1)
        out[t0:t1] = combine(flat.reshape(t1 - t0, W, cpw).astype(np.int32))
    return out


def pack5(tiles: np.ndarray, out: np.ndarray | None = None, slab: int = 64) -> np.ndarray:
    """b32 pack: int8 code tiles [T, ...] -> int32 [T, words_for(E)]."""

    def combine(grp):
        acc = grp[:, :, 0].copy()
        for k in range(1, CPW):
            acc |= grp[:, :, k] << (5 * k)
        return acc

    return _pack_slabs(tiles, out, CPW, 31, combine, slab)


def pack21(tiles: np.ndarray, out: np.ndarray | None = None, slab: int = 64) -> np.ndarray:
    """b21 pack: int8 code tiles [T, ...] (codes 0..20) -> int32 [T, W21];
    word = sum_k code_k * 21^k."""

    def combine(grp):
        acc = grp[:, :, CPW21 - 1].copy()
        for k in range(CPW21 - 2, -1, -1):
            acc *= BASE21
            acc += grp[:, :, k]
        return acc

    return _pack_slabs(tiles, out, CPW21, BASE21 - 1, combine, slab)


def _unpack(packed: torch.Tensor, shape, cpw: int, digit) -> torch.Tensor:
    """int8 [T, *shape] on ``packed``'s device from int32 words [T, W]:
    ``digit(words, k)`` gives code k of every word as an int32 tensor."""
    if packed.dtype != torch.int32 or packed.dim() != 2:
        raise ValueError(f"packed words must be int32 [T, W], got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    T, W = packed.shape
    E = int(np.prod(shape))
    if W * cpw < E:
        raise ValueError(f"{W} words of {cpw} codes cannot hold {E} codes")
    out = torch.empty((T, W, cpw), dtype=torch.int8, device=packed.device)
    for k in range(cpw):
        out[:, :, k] = digit(packed, k)
    flat = out.view(T, W * cpw)
    if W * cpw != E:
        flat = flat[:, :E].contiguous()
    return flat.view((T,) + tuple(shape))


def unpack5(packed: torch.Tensor, shape) -> torch.Tensor:
    """Device unpack of b32 words: int32 [T, W] -> int8 [T, *shape]."""
    return _unpack(packed, shape, CPW, lambda w, k: (w >> (5 * k)) & 31)


def unpack21(packed: torch.Tensor, shape) -> torch.Tensor:
    """Device unpack of b21 words: int32 [T, W] -> int8 [T, *shape]
    (constant divisions by 21 of non-negative words)."""
    scale = [BASE21 ** k for k in range(CPW21)]
    return _unpack(packed, shape, CPW21,
                   lambda w, k: torch.div(w, scale[k], rounding_mode="floor") % BASE21)


def unpack5_np(packed: np.ndarray, shape) -> np.ndarray:
    """Host reference of ``unpack5``."""
    T, W = packed.shape
    E = int(np.prod(shape))
    chars = (packed[:, :, None] >> (np.arange(CPW, dtype=np.int32) * 5)) & 31
    return chars.reshape(T, W * CPW)[:, :E].astype(np.int8).reshape((T,) + tuple(shape))


def unpack21_np(packed: np.ndarray, shape) -> np.ndarray:
    """Host reference of ``unpack21``."""
    T, W = packed.shape
    E = int(np.prod(shape))
    w = packed.astype(np.int64)
    digits = []
    for _ in range(CPW21):
        digits.append((w % BASE21).astype(np.int8))
        w = w // BASE21
    chars = np.stack(digits, axis=-1)
    return chars.reshape(T, W * CPW21)[:, :E].reshape((T,) + tuple(shape))


#: codec name -> (codes a word, words_for, pack, device unpack, host unpack,
#: largest code).  ``b21`` needs the classic alphabet; ``b32`` also covers
#: the full-blosum one (pad 25).
CODECS = {
    "b32": (CPW, words_for, pack5, unpack5, unpack5_np, 31),
    "b21": (CPW21, words_for21, pack21, unpack21, unpack21_np, BASE21 - 1),
}


def choose_codec(mode: str, pad: int) -> str | None:
    """The codec a ``CUDASW4_TPU_TORCH_STREAM_PACK`` value selects: "1"
    b32, "2" b21 where the alphabet allows it (pad < 21; the full-blosum
    pad 25 takes b32); anything else turns packing off."""
    if mode == "1":
        return "b32"
    if mode == "2":
        return "b21" if pad < BASE21 else "b32"
    return None
