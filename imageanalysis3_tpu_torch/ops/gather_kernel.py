"""Pixel gathers of the Gaussian fit: CUDA kernel entries and plain versions.

The counterpart of ``scripts/ab_gather2.py:gather_aligned``, the Pallas form
of the cube step of ``imageanalysis3_tpu/ops/gaussian_fit.py:gather_blocks``.
One kernel source (``csrc/gather_cubes.cu``), two entries:

* :func:`gather_cubes` cuts the (sz, sx, sy) cube at each of N origins out
  of a (Z, X, Y) stack; each origin is first clipped into [0, dim - side] on
  each axis, so no origin reads outside the stack.
* :func:`gather_ball` writes what ``gather_blocks`` packs out of those
  cubes, the (N, P) pixels of each seed's fitting ball with their
  coordinates and in-bounds mask, with no cube array in between.

A CUDA tensor goes to the kernel (the output's elements flattened over the
threads); a CPU tensor to the plain version: one gather with a precomputed
index, and for the ball the cube-then-pack the JAX package computes.
``launches`` counts both entries.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import _build

#: kernel launches made by :func:`gather_cubes_cuda` and
#: :func:`gather_ball_cuda` (reset by callers that check which path ran)
launches = 0


def cube_sides(shape: Sequence[int], radius: int) -> Tuple[int, int, int]:
    """Per-axis cube extent of a radius-`radius` fitting ball: 2r, clamped
    to the stack (thin stacks are thinner than the ball along z)."""
    return tuple(min(2 * int(radius), int(s)) for s in shape)


def ball_offsets(radius: int) -> np.ndarray:
    """(P, 3) integer offsets inside the fitting ball, with the reference's
    asymmetric range [-r, r) and |o| <= r filter (iter_fit :580-583)."""
    g = np.indices([2 * radius] * 3).reshape(3, -1).T - radius
    keep = (g ** 2).sum(1) <= radius ** 2
    return g[keep].astype(np.int32)


@functools.lru_cache(maxsize=32)
def _origin_bounds(shape: Tuple[int, ...], sides: Tuple[int, ...],
                   device: torch.device) -> torch.Tensor:
    """(3,) int64 upper bounds dim - side, made on `device` once per
    (shape, sides, device): a call copies nothing from the host."""
    return torch.tensor([s - d for s, d in zip(shape, sides)],
                        dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=32)
def _ball_constants(shape: Tuple[int, ...], radius: int,
                    device: torch.device):
    """The ball offsets (P, 3) int32, the stack shape (3,) and the cube
    sides less one (3,), made on `device` once per (shape, radius, device):
    a gather copies nothing from the host."""
    sides = cube_sides(shape, radius)
    return (torch.as_tensor(ball_offsets(radius), device=device),
            torch.tensor(shape, device=device),
            torch.tensor([d - 1 for d in sides], device=device))


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


def _check_cuda(entry: str, *named) -> None:
    for name, t, dtype in named:
        if not t.is_cuda:
            raise ValueError(f"{entry}: {name} must be a CUDA tensor")
        if t.dtype != dtype:
            raise ValueError(f"{entry}: {name} must be {dtype}, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{entry}: {name} must be contiguous")


def _launch(entry: str, argtypes, *args) -> None:
    """Call ``<entry>_launch`` of ``csrc/gather_cubes.cu``, raise on a
    nonzero rc, count the launch."""
    global launches
    lib = _build.load("gather_cubes")
    fn = getattr(lib, f"{entry}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    rc = fn(*args)
    if rc != 0:
        err = lib.ia3_cuda_error_string
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{entry} kernel launch failed: "
                           f"{err(rc).decode()} ({rc})")
    launches += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def gather_cubes_cuda(im: torch.Tensor, origins: torch.Tensor,
                      sides: Sequence[int]) -> torch.Tensor:
    """Launch the cube entry of ``csrc/gather_cubes.cu`` on the current
    stream."""
    _check_cuda("gather_cubes_cuda", ("im", im, torch.float32),
                ("origins", origins, torch.int32))
    if im.dim() != 3 or origins.dim() != 2 or origins.shape[1] != 3:
        raise ValueError(f"gather_cubes_cuda: expected im (Z, X, Y) and "
                         f"origins (N, 3), got {tuple(im.shape)} and "
                         f"{tuple(origins.shape)}")
    sz, sx, sy = _check_sides(im.shape, sides)
    n = origins.shape[0]
    out = torch.empty((n, sz, sx, sy), dtype=torch.float32, device=im.device)
    if n == 0:
        return out
    _launch("gather_cubes", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
            + [ctypes.c_void_p],
            im.data_ptr(), origins.data_ptr(), out.data_ptr(), n, *im.shape,
            sz, sx, sy, _stream(im))
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


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """``astype(int32)`` as XLA converts: truncation toward zero, NaN to 0,
    out-of-range values saturated (PyTorch's own conversion of those is
    undefined and differs between CPU and CUDA)."""
    if not x.is_floating_point():
        return x.to(torch.int32)
    x = torch.nan_to_num(x.to(torch.float32), nan=0.0)
    # 2**31 and above saturate to the int32 maximum; the rest convert from
    # at most 2147483520, the largest f32 below 2**31
    return torch.where(x >= 2147483648.0, 2147483647,
                       x.clamp(-2147483648.0, 2147483520.0).to(torch.int32))


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 `x` wrapped into the int32 range, as XLA's int32 arithmetic
    wraps (two's complement)."""
    return ((x + 2 ** 31) & (2 ** 32 - 1)) - 2 ** 31


def gather_ball_plain(im: torch.Tensor, seeds: torch.Tensor, radius: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fitting balls of N seeds (N, 3) as the JAX package gathers them
    (gaussian_fit.py:394-409): the seeds converted to int32 as XLA converts
    them (``base``), each seed's (2r)^3 cube (2r clamped to the stack) at
    its origin ``base - r`` clipped into the stack, then the in-ball
    offsets, each clipped into its cube -> (pixels (N, P) f32, coords
    (N, P, 3) f32, inb (N, P) bool).  The positions, the origin and the
    in-cube offsets are int32 sums that wrap as XLA's do, so a seed
    saturated at the int32 range gets the JAX package's coordinates.  Every
    in-bounds ball pixel lies inside the cube; an out-of-bounds one reads a
    cube voxel, the same as in the JAX package, and is masked out by
    ``inb``."""
    n = seeds.shape[0]
    sides = cube_sides(im.shape, radius)
    offs, shape, last = _ball_constants(tuple(im.shape), int(radius),
                                        im.device)
    base = _to_int32(seeds).to(torch.int64)
    pos = _wrap_int32(base[:, None, :] + offs[None, :, :])       # (N, P, 3)
    inb = ((pos >= 0) & (pos < shape)).all(dim=-1)
    origin = clip_origins(_wrap_int32(base - radius), im.shape, sides)
    cubes = gather_cubes_plain(im, origin, sides)            # (N, sz, sx, sy)
    rel = torch.minimum(
        _wrap_int32(pos - origin[:, None, :]).clamp_min(0), last)
    idx = (rel[..., 0] * sides[1] + rel[..., 1]) * sides[2] + rel[..., 2]
    pixels = torch.gather(cubes.reshape(n, -1), 1, idx)
    return pixels, pos.to(torch.float32), inb


def gather_ball_cuda(im: torch.Tensor, seeds: torch.Tensor, radius: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the ball entry of ``csrc/gather_cubes.cu`` on the current
    stream: :func:`gather_ball_plain`'s outputs in one launch, the seeds'
    conversion included (f32 seeds convert in the kernel, int32 ones are
    taken as they are), no cube array."""
    if seeds.dtype not in (torch.float32, torch.int32):
        raise ValueError(f"gather_ball_cuda: seeds must be float32 or "
                         f"int32, got {seeds.dtype}")
    _check_cuda("gather_ball_cuda", ("im", im, torch.float32),
                ("seeds", seeds, seeds.dtype))
    if im.dim() != 3 or seeds.dim() != 2 or seeds.shape[1] != 3:
        raise ValueError(f"gather_ball_cuda: expected im (Z, X, Y) and "
                         f"seeds (N, 3), got {tuple(im.shape)} and "
                         f"{tuple(seeds.shape)}")
    radius = int(radius)
    if radius < 1:
        raise ValueError(f"gather_ball_cuda: radius {radius} must be >= 1")
    sides = cube_sides(im.shape, radius)
    offs, _, _ = _ball_constants(tuple(im.shape), radius, im.device)
    n, p = seeds.shape[0], offs.shape[0]
    dev = im.device
    pixels = torch.empty((n, p), dtype=torch.float32, device=dev)
    coords = torch.empty((n, p, 3), dtype=torch.float32, device=dev)
    inb = torch.empty((n, p), dtype=torch.bool, device=dev)
    if n == 0:
        return pixels, coords, inb
    _launch("gather_ball", [ctypes.c_void_p] * 2 + [ctypes.c_int]
            + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
            im.data_ptr(), seeds.data_ptr(),
            int(seeds.dtype == torch.float32), offs.data_ptr(),
            pixels.data_ptr(), coords.data_ptr(), inb.data_ptr(), n, p,
            radius, *im.shape, *sides, _stream(im))
    return pixels, coords, inb


def gather_occupancy_cuda(ball: bool) -> Tuple[int, int]:
    """(resident blocks per SM, threads per block) of the ball (`ball`) or
    cube entry's kernel, as the card grants them."""
    out = [ctypes.c_int(0) for _ in range(2)]
    fn = _build.load("gather_cubes").gather_cubes_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 2
    rc = fn(int(bool(ball)), *(ctypes.addressof(v) for v in out))
    if rc != 0:
        raise RuntimeError(f"gather_cubes occupancy query failed ({rc})")
    return tuple(v.value for v in out)


def gather_ball(im: torch.Tensor, seeds: torch.Tensor, radius: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(pixels, coords, inb) of the radius-`radius` balls around the seeds
    (N, 3), converted to int32 as XLA converts them: the CUDA kernel for
    CUDA tensors (float seeds as float32, integer ones as int32),
    :func:`gather_ball_plain` for CPU tensors."""
    if im.is_cuda:
        dtype = torch.float32 if seeds.is_floating_point() else torch.int32
        return gather_ball_cuda(im.to(torch.float32).contiguous(),
                                seeds.to(dtype).contiguous(), radius)
    if im.device.type != "cpu":
        raise ValueError(f"gather_ball: no kernel for device {im.device}")
    return gather_ball_plain(im.to(torch.float32), seeds, radius)
