"""cudasw4_tpu_torch — the PyTorch and CUDA port of cudasw4_tpu for Hopper.

Smith-Waterman protein database search on an NVIDIA H100: the same
``makedb``-compatible database files, length-bucketed tile packing,
affine-gap local alignment scores and top-N output as the JAX package
``cudasw4_tpu``, with every scoring kernel written by hand in CUDA C++
(``csrc/``) and plain PyTorch versions of each kernel for the CPU.

This package never imports ``jax`` or ``cudasw4_tpu``; it keeps its own
copies of the numpy-only modules it needs.
"""

from .constants import ALPHABET_SIZE, AMINO_ACIDS, UNKNOWN, decode, encode
from .substitution import (
    MATRICES_20,
    MATRICES_FULL,
    BlosumType,
    ScoringConfig,
    make_scoring_config,
)

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy conveniences: the engine pulls in torch, which host-only uses
    # (makedb) need not pay for.
    if name == "SearchEngine":
        from .engine import SearchEngine

        return SearchEngine
    if name == "load_db":
        from .db.format import load_db

        return load_db
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ALPHABET_SIZE",
    "AMINO_ACIDS",
    "UNKNOWN",
    "encode",
    "decode",
    "BlosumType",
    "ScoringConfig",
    "make_scoring_config",
    "MATRICES_20",
    "MATRICES_FULL",
    "__version__",
]
