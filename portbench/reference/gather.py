"""The fit's pixel gather in the plain reference: the plain version of the
port's gather_cubes kernel (imageanalysis3_tpu_torch/ops/gather_kernel.py).

Frozen at the port's commit 5edc061; edit only to fix the reference.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch


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
