"""DNA 2-bit k-mer packing: ctypes bindings for the native kernel.

The port's copy of ``imageanalysis3_tpu/library/seqint.py`` and of its C++
source.  Behavior target: reference library_tools/C_Tools/seqint.pyx:1-56
(seq2Int / seq2Int_rc) -- the only compiled extension in the reference.
The kernel is C++ (``native/seqint.cpp``), compiled with g++ on first use
into the package's build directory (``build/torch_kernels/seqint/<hash>/``
of the source tree, or ``$XDG_CACHE_HOME/imageanalysis3_tpu_torch/seqint/
<hash>/`` for an installed copy, as the native ``.dax`` loader builds),
keyed by a hash of the source and flags, and loaded only when it is owned
by this user and writable by no one else.  Without a compiler a vectorized
NumPy path gives the same values; this is host code, not a device path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

from .._build import load_native_library

_SRC = os.path.join(os.path.dirname(__file__), "native", "seqint.cpp")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_BASE_LUT = np.zeros(256, np.uint64)
for b, v in (("C", 1), ("G", 2), ("T", 3)):
    _BASE_LUT[ord(b)] = v
    _BASE_LUT[ord(b.lower())] = v
_BASE_LUT_RC = np.zeros(256, np.uint64)
for b, v in (("A", 3), ("C", 2), ("G", 1)):
    _BASE_LUT_RC[ord(b)] = v
    _BASE_LUT_RC[ord(b.lower())] = v

_lib = None
_lib_tried = False


def _build_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    try:
        lib = load_native_library("seqint", _SRC, GXX_FLAGS)
        lib.seq2int.restype = ctypes.c_uint64
        lib.seq2int.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.seq2int_rc.restype = ctypes.c_uint64
        lib.seq2int_rc.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.seq_to_kmers.restype = ctypes.c_int64
        lib.seq_to_kmers.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64)]
        lib.count_kmers_dense.restype = None
        lib.count_kmers_dense.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_uint64]
        _lib = lib
    except (OSError, subprocess.CalledProcessError, AttributeError):
        # no compiler, a failed build or load, or a foreign library: the
        # NumPy path serves
        _lib = None
    return _lib


def _as_bytes(seq) -> bytes:
    if isinstance(seq, bytes):
        return seq
    return str(seq).encode()


def seq2int(seq) -> int:
    """Pack a sequence into a 2-bit integer (reference seq2Int)."""
    b = _as_bytes(seq)
    lib = _build_lib()
    if lib is not None:
        return int(lib.seq2int(b, len(b)))
    codes = _BASE_LUT[np.frombuffer(b, np.uint8)]
    v = 0
    for c in codes:
        v = (v << 2) | int(c)
    return v


def seq2int_rc(seq) -> int:
    """Pack the reverse complement (reference seq2Int_rc)."""
    b = _as_bytes(seq)
    lib = _build_lib()
    if lib is not None:
        return int(lib.seq2int_rc(b, len(b)))
    codes = _BASE_LUT_RC[np.frombuffer(b, np.uint8)][::-1]
    v = 0
    for c in codes:
        v = (v << 2) | int(c)
    return v


def seq_to_kmer_ints(seq, word: int,
                     with_rc: bool = True
                     ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """All k-mer codes of `seq` -> (fw (N,), rc (N,) or None), uint64.

    Native rolling kernel when available; otherwise a vectorized NumPy
    sliding-window dot with the 4^j weight vector.
    """
    b = _as_bytes(seq)
    n = len(b)
    if n < word:
        empty = np.zeros(0, np.uint64)
        return empty, (empty.copy() if with_rc else None)
    m = n - word + 1
    lib = _build_lib()
    if lib is not None:
        fw = np.empty(m, np.uint64)
        rc = np.empty(m, np.uint64) if with_rc else None
        lib.seq_to_kmers(
            b, n, word,
            fw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            rc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
            if with_rc else None)
        return fw, rc
    return _kmers_numpy(b, word, with_rc)


def _kmers_numpy(b: bytes, word: int, with_rc: bool):
    """`seq_to_kmer_ints`'s NumPy path, for sequences of >= `word` bases."""
    arr = np.frombuffer(b, np.uint8)
    codes = _BASE_LUT[arr].astype(np.uint64)
    weights = (4 ** np.arange(word - 1, -1, -1)).astype(np.uint64)
    win = np.lib.stride_tricks.sliding_window_view(codes, word)
    fw = (win * weights[None]).sum(axis=1).astype(np.uint64)
    if not with_rc:
        return fw, None
    codes_rc = _BASE_LUT_RC[arr].astype(np.uint64)
    w_rc = (4 ** np.arange(word)).astype(np.uint64)
    win_rc = np.lib.stride_tricks.sliding_window_view(codes_rc, word)
    rc = (win_rc * w_rc[None]).sum(axis=1).astype(np.uint64)
    return fw, rc


def count_kmers_dense(kmers: np.ndarray, table: np.ndarray) -> None:
    """Saturating scatter-add of k-mer codes into a dense uint16 table."""
    kmers = np.ascontiguousarray(kmers, np.uint64)
    if table.dtype != np.uint16 or not table.flags.c_contiguous:
        raise ValueError("count table must be a C-contiguous uint16 array")
    lib = _build_lib()
    if lib is not None:
        lib.count_kmers_dense(
            kmers.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(kmers),
            table.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            table.size)
        return
    _count_dense_numpy(kmers, table)


def _count_dense_numpy(kmers: np.ndarray, table: np.ndarray) -> None:
    """`count_kmers_dense`'s NumPy path."""
    pos, cts = np.unique(kmers, return_counts=True)
    pos = pos[pos < table.size]
    cts = cts[:len(pos)]
    merged = table[pos].astype(np.uint32) + cts
    table[pos] = np.clip(merged, 0, 65535).astype(np.uint16)


def native_available() -> bool:
    """True when the compiled kernel is usable."""
    return _build_lib() is not None
