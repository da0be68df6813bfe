"""Native fused .dax loader: ctypes bindings for io/native/daxload.cpp.

The port's own copy of ``imageanalysis3_tpu/io/native_loader.py`` and of
its C++ source.  `load_dax_channels` replaces the read-whole-movie-then-
slice host path (reference io_tools/load.py:471-550) with one parallel
pass: worker threads pread() each (channel, z) frame from the file straight
into its slot in the per-channel output block -- no staging movie, no
second copy.

Compiled with ``g++ -O3 -shared -fPIC -pthread`` on first use into the
package's build directory (``build/torch_kernels/daxload/<hash>/`` of the
source tree, or ``$XDG_CACHE_HOME/imageanalysis3_tpu_torch/daxload/<hash>/``
for an installed copy, as ``_build`` places the CUDA kernels), keyed by a
hash of the source and flags.  The library is loaded only when it is owned
by this user and writable by no one else.  Without a compiler the NumPy
path (read_dax + split_channels) gives the same values; this is host I/O,
not a device path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Sequence

import numpy as np

from .._build import load_native_library, native_library_path
from .dax import DaxMetadata, channel_start_frames, read_dax, read_inf, \
    split_channels

_SRC = os.path.join(os.path.dirname(__file__), "native", "daxload.cpp")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_lib = None
_lib_tried = False


def library_path() -> str:
    """Where the compiled loader lives: a 0700 directory keyed by a hash of
    the source and the flags."""
    return str(native_library_path("daxload", _SRC, GXX_FLAGS))


def _build_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    try:
        lib = load_native_library("daxload", _SRC, GXX_FLAGS)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.dax_load_channels.restype = ctypes.c_int
        lib.dax_load_channels.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, i64p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, u8p, ctypes.c_int]
        lib.dax_split_channels.restype = None
        lib.dax_split_channels.argtypes = [
            u8p, ctypes.c_int64, i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, u8p, ctypes.c_int]
        _lib = lib
    except (OSError, subprocess.CalledProcessError, AttributeError):
        # no compiler, a failed build or load, or a foreign library: the
        # NumPy path serves
        _lib = None
    return _lib


def native_loader_available() -> bool:
    """True when the compiled fast path is usable."""
    return _build_lib() is not None


def _default_threads() -> int:
    return min(8, os.cpu_count() or 4)


def _stacked(stacks, out: Optional[np.ndarray]) -> np.ndarray:
    if out is None:
        return np.stack(stacks)
    for i, s in enumerate(stacks):
        np.copyto(out[i], s)
    return out


def load_dax_channels(filename: str,
                      sel_channels: Sequence[str],
                      all_channels: Sequence[str],
                      n_z: int = 30,
                      buffer_frames: int = 10,
                      empty_frames: int = 0,
                      skip_frame0: bool = False,
                      meta: Optional[DaxMetadata] = None,
                      out: Optional[np.ndarray] = None,
                      n_threads: Optional[int] = None) -> np.ndarray:
    """Fused read + de-interleave -> (n_sel, n_z, H, W) uint16 block.

    The values of ``read_dax`` followed by ``split_channels``, in one
    parallel pass over the file.  ``out``: optional preallocated
    C-contiguous (n_sel, n_z, H, W) uint16 block.  Falls back to the NumPy
    path when the native library is unavailable.
    """
    if meta is None:
        meta = read_inf(filename)
    starts, n_colors = channel_start_frames(
        sel_channels, all_channels, buffer_frames=buffer_frames,
        empty_frames=empty_frames, skip_frame0=skip_frame0)
    h, w = meta.frame_shape
    shape = (len(starts), n_z, h, w)
    if out is not None:
        if out.shape != shape or out.dtype != np.uint16:
            raise ValueError(f"out block {out.shape}/{out.dtype} does "
                             f"not match {shape} uint16")
        if not out.flags.c_contiguous:
            raise ValueError("out block must be C-contiguous")
    need = max(s + (n_z - 1) * n_colors for s in starts) + 1
    if need > meta.number_frames:
        raise ValueError(f"movie has {meta.number_frames} frames; "
                         f"layout needs {need}")

    lib = _build_lib()
    if lib is None:
        movie, _ = read_dax(filename, meta=meta)
        return _stacked(split_channels(
            movie, sel_channels, all_channels, n_z=n_z,
            buffer_frames=buffer_frames, empty_frames=empty_frames,
            skip_frame0=skip_frame0), out)

    block = out if out is not None else np.empty(shape, np.uint16)
    starts_arr = np.asarray(starts, np.int64)
    rc = lib.dax_load_channels(
        filename.encode(), ctypes.c_int64(h * w * 2),
        starts_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(starts)), ctypes.c_int64(n_colors),
        ctypes.c_int64(n_z),
        block.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int(n_threads or _default_threads()))
    if rc != 0:
        raise IOError(f"native dax load failed (rc={rc}) for {filename}")
    if meta.big_endian:
        block.byteswap(inplace=True)
    return block


def split_channels_native(movie: np.ndarray,
                          sel_channels: Sequence[str],
                          all_channels: Sequence[str],
                          n_z: int = 30,
                          buffer_frames: int = 10,
                          empty_frames: int = 0,
                          skip_frame0: bool = False,
                          out: Optional[np.ndarray] = None,
                          n_threads: Optional[int] = None) -> np.ndarray:
    """Parallel in-memory de-interleave -> (n_sel, n_z, H, W) block: the
    values of ``split_channels``.  Needs a native-byte-order C-contiguous
    uint16 movie; otherwise the NumPy path runs."""
    starts, n_colors = channel_start_frames(
        sel_channels, all_channels, buffer_frames=buffer_frames,
        empty_frames=empty_frames, skip_frame0=skip_frame0)
    h, w = movie.shape[1:]
    shape = (len(starts), n_z, h, w)
    need = max(s + (n_z - 1) * n_colors for s in starts) + 1
    if need > movie.shape[0]:
        raise ValueError(f"movie has {movie.shape[0]} frames; layout needs "
                         f"{need}")
    if out is not None and (out.shape != shape
                            or out.dtype != np.uint16
                            or not out.flags.c_contiguous):
        raise ValueError(f"out block must be C-contiguous {shape} uint16")
    lib = _build_lib()
    if not (lib is not None and movie.dtype == np.uint16
            and movie.dtype.isnative and movie.flags.c_contiguous):
        return _stacked(split_channels(
            movie, sel_channels, all_channels, n_z=n_z,
            buffer_frames=buffer_frames, empty_frames=empty_frames,
            skip_frame0=skip_frame0), out)
    block = out if out is not None else np.empty(shape, np.uint16)
    starts_arr = np.asarray(starts, np.int64)
    lib.dax_split_channels(
        movie.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(h * w * 2),
        starts_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(starts)), ctypes.c_int64(n_colors),
        ctypes.c_int64(n_z),
        block.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int(n_threads or _default_threads()))
    return block
