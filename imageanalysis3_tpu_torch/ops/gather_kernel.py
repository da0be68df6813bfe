"""Cube gather: CUDA kernel and its plain version.

The counterpart of ``scripts/ab_gather2.py:gather_aligned``, the Pallas form
of the cube step of ``imageanalysis3_tpu/ops/gaussian_fit.py:gather_blocks``.
:func:`gather_cubes` cuts the (sz, sx, sy) cube at each of N origins out of
a (Z, X, Y) stack; each origin is first clipped into [0, dim - side] on each
axis, so no origin reads outside the stack.

A CUDA tensor goes to ``csrc/gather_cubes.cu`` (one block per cube); a CPU
tensor to :func:`gather_cubes_plain`, one gather with a precomputed index.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from .. import _build

#: kernel launches made by :func:`gather_cubes_cuda` (reset by callers that
#: check which path ran)
launches = 0


def cube_sides(shape: Sequence[int], radius: int) -> Tuple[int, int, int]:
    """Per-axis cube extent of a radius-`radius` fitting ball: 2r, clamped
    to the stack (thin stacks are thinner than the ball along z)."""
    return tuple(min(2 * int(radius), int(s)) for s in shape)


@functools.lru_cache(maxsize=32)
def _origin_bounds(shape: Tuple[int, ...], sides: Tuple[int, ...],
                   device: torch.device) -> torch.Tensor:
    """(3,) int64 upper bounds dim - side, made on `device` once per
    (shape, sides, device): a call copies nothing from the host."""
    return torch.tensor([s - d for s, d in zip(shape, sides)],
                        dtype=torch.int64, device=device)


def clip_origins(origins: torch.Tensor, shape: Sequence[int],
                 sides: Sequence[int]) -> torch.Tensor:
    """(N, 3) int origins clipped into [0, dim - side] per axis -> int32."""
    hi = _origin_bounds(tuple(int(s) for s in shape),
                        tuple(int(d) for d in sides), origins.device)
    return torch.minimum(origins.to(torch.int64).clamp_min(0),
                         hi).to(torch.int32)


def cube_index(shape: Sequence[int], origins: torch.Tensor,
               sides: Sequence[int]) -> torch.Tensor:
    """(N, sz, sx, sy) int64 flat indices into a (Z, X, Y) stack of the
    cubes at the clipped `origins`."""
    sz, sx, sy = (int(s) for s in sides)
    o = clip_origins(origins, shape, sides).to(torch.int64)
    dev = origins.device
    a = torch.arange(sz, device=dev)[:, None, None]
    b = torch.arange(sx, device=dev)[None, :, None]
    c = torch.arange(sy, device=dev)[None, None, :]
    z = o[:, 0, None, None, None] + a
    x = o[:, 1, None, None, None] + b
    y = o[:, 2, None, None, None] + c
    return (z * int(shape[1]) + x) * int(shape[2]) + y


def gather_cubes_plain(im: torch.Tensor, origins: torch.Tensor,
                       sides: Sequence[int]) -> torch.Tensor:
    """(N, sz, sx, sy) cubes of `im` in plain PyTorch: one gather with the
    precomputed index grid of :func:`cube_index`."""
    return torch.take(im, cube_index(im.shape, origins, sides))


def _check_sides(shape, sides) -> Tuple[int, int, int]:
    sides = tuple(int(s) for s in sides)
    if len(sides) != 3 or not all(1 <= d <= s for d, s in zip(sides, shape)):
        raise ValueError(f"gather_cubes: sides {sides} must lie in 1..dim of "
                         f"the stack {tuple(shape)}")
    return sides


def gather_cubes_cuda(im: torch.Tensor, origins: torch.Tensor,
                      sides: Sequence[int]) -> torch.Tensor:
    """Launch ``csrc/gather_cubes.cu`` on the current stream."""
    global launches
    for name, t, dtype in (("im", im, torch.float32),
                           ("origins", origins, torch.int32)):
        if not t.is_cuda:
            raise ValueError(f"gather_cubes_cuda: {name} must be a CUDA "
                             "tensor")
        if t.dtype != dtype:
            raise ValueError(f"gather_cubes_cuda: {name} must be {dtype}, "
                             f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"gather_cubes_cuda: {name} must be contiguous")
    if im.dim() != 3 or origins.dim() != 2 or origins.shape[1] != 3:
        raise ValueError(f"gather_cubes_cuda: expected im (Z, X, Y) and "
                         f"origins (N, 3), got {tuple(im.shape)} and "
                         f"{tuple(origins.shape)}")
    sz, sx, sy = _check_sides(im.shape, sides)
    n = origins.shape[0]
    out = torch.empty((n, sz, sx, sy), dtype=torch.float32, device=im.device)
    if n == 0:
        return out
    lib = _build.load("gather_cubes")
    fn = lib.gather_cubes_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    rc = fn(im.data_ptr(), origins.data_ptr(), out.data_ptr(), n,
            *im.shape, sz, sx, sy,
            torch.cuda.current_stream(im.device).cuda_stream)
    if rc != 0:
        err = lib.ia3_cuda_error_string
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"gather_cubes kernel launch failed: "
                           f"{err(rc).decode()} ({rc})")
    launches += 1
    return out


def gather_cubes(im: torch.Tensor, origins: torch.Tensor,
                 sides: Sequence[int]) -> torch.Tensor:
    """(N, sz, sx, sy) f32 cubes of `im` (Z, X, Y) at the clipped `origins`
    (N, 3): the CUDA kernel for CUDA tensors, :func:`gather_cubes_plain`
    for CPU tensors."""
    if im.is_cuda:
        return gather_cubes_cuda(im.to(torch.float32).contiguous(),
                                 origins.to(torch.int32).contiguous(), sides)
    if im.device.type != "cpu":
        raise ValueError(f"gather_cubes: no kernel for device {im.device}")
    _check_sides(im.shape, sides)
    return gather_cubes_plain(im.to(torch.float32), origins, sides)
