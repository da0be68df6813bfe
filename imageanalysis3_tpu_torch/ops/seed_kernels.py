"""Pyramid-background seeding classifier: CUDA kernel and its plain version.

The counterpart of ``imageanalysis3_tpu/ops/pallas_kernels.py:
fused_seed_classify_pyramid``.  The background Gaussian (sigma ~7.5, a
61-tap reach) runs on a 4x4 xy-pooled grid at sigma/4 and is bilinearly
upsampled inside the classifier, so the full-resolution background stack
never exists in device memory.

:func:`fused_seed_classify_pyramid` does the host prep in PyTorch
(:func:`pyramid_background`: mean pool, bg blur, plateau sentinel), then
hands the corrected stack and the pooled bg to ``csrc/seed_pyramid.cu`` for
a CUDA tensor or to :func:`fused_seed_classify_pyramid_plain` for a CPU
tensor.  Both return ``(qdiff, counts)``: the fg-bg signal where the voxel
is a fg 3^3 local maximum inside the edge margin (-inf elsewhere), and the
per-level histogram of those voxels.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from .. import _build
from .filters import (_conv1d_along_axis, _shift_add, _window_reduce,
                      gaussian_kernel1d)

#: kernel launches made by :func:`fused_seed_classify_pyramid_cuda`
launches = 0

MAX_FG_RADIUS = 12
MAX_LEVELS = 128


def pyramid_background(im: torch.Tensor, sigma_bg: float) -> torch.Tensor:
    """Pooled, blurred, plateau-marked background (Z, X/4, Y/4) f32.

    4x4 mean pool; z blur with the full sigma_bg kernel, xy blur at
    sigma_bg/4 (pooling's own bandlimit makes up the rest).  Plateau guard:
    the exact classifier rejects voxels where min3(bg) == bg, i.e. flat
    background plateaus; here cells whose 3^3 neighbourhood has a range
    <= 4e-5 * max(|max|, 1) get the finite sentinel 1e9, which drives the
    signal far below any threshold.
    """
    z, x, y = im.shape
    pooled = im.to(torch.float32).reshape(z, x // 4, 4, y // 4, 4) \
        .sum(dim=(2, 4)) / 16.0
    k_bg = gaussian_kernel1d(sigma_bg)
    k_bgs = gaussian_kernel1d(float(sigma_bg) / 4.0)
    bgs = _conv1d_along_axis(pooled, k_bg, 0, "reflect")
    bgs = _conv1d_along_axis(bgs, k_bgs, 1, "reflect")
    bgs = _conv1d_along_axis(bgs, k_bgs, 2, "reflect")
    bmax = _window_reduce(bgs, 3, "nearest", "max")
    bmin = _window_reduce(bgs, 3, "nearest", "min")
    flat = (bmax - bmin) <= 4e-5 * bmax.abs().clamp_min(1.0)
    return torch.where(flat, torch.full_like(bgs, 1e9), bgs).contiguous()


def _blur_in_tap_order(im: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Separable 'reflect' blur along z, x, y by shift-add on every axis
    (also where gaussian_filter would take a band matmul, e.g. z <= 7):
    the kernel's exact arithmetic."""
    for ax in range(3):
        im = _shift_add(im, kernel, ax, "reflect")
    return im


def _bilinear_axis(n_fine: int, n_pooled: int, device):
    """(i0, i1, w0, w1) of the half-pixel bilinear 4x upsample along one
    axis: source (g + 0.5)/4 - 0.5, indices edge-clamped."""
    s = (np.arange(n_fine) + 0.5) / 4.0 - 0.5
    f = np.floor(s)
    w1 = (s - f).astype(np.float32)
    i = f.astype(np.int64)
    i0 = np.clip(i, 0, n_pooled - 1)
    i1 = np.clip(i + 1, 0, n_pooled - 1)
    return (torch.from_numpy(i0).to(device), torch.from_numpy(i1).to(device),
            torch.from_numpy(1.0 - w1).to(device),
            torch.from_numpy(w1).to(device))


def upsample_background(bgs: torch.Tensor, x: int, y: int) -> torch.Tensor:
    """Half-pixel bilinear 4x upsample of the pooled bg to (Z, X, Y): the y
    interpolation first, then x, as the kernel computes it."""
    iy0, iy1, wy0, wy1 = _bilinear_axis(y, bgs.shape[2], bgs.device)
    ix0, ix1, wx0, wx1 = _bilinear_axis(x, bgs.shape[1], bgs.device)
    by = bgs[:, :, iy0] * wy0 + bgs[:, :, iy1] * wy1
    return by[:, ix0, :] * wx0[:, None] + by[:, ix1, :] * wx1[:, None]


def _edge_ok(shape, d: int, device) -> torch.Tensor:
    z, x, y = shape
    zi = torch.arange(z, device=device)[:, None, None]
    xi = torch.arange(x, device=device)[None, :, None]
    yi = torch.arange(y, device=device)[None, None, :]
    return ((zi >= d) & (zi <= z - d) & (xi >= d) & (xi <= x - d)
            & (yi >= d) & (yi <= y - d))


def fused_seed_classify_pyramid_plain(im: torch.Tensor, bgs: torch.Tensor,
                                      k_fg: np.ndarray, th: float,
                                      n_lvl: int, min_edge_distance: int
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``csrc/seed_pyramid.cu`` on the same inputs
    -> (qdiff (Z, X, Y) f32, counts (n_lvl,) int32)."""
    fg = _blur_in_tap_order(im.to(torch.float32), k_fg)
    local_max = _window_reduce(fg, 3, "reflect", "max") == fg
    bg = upsample_background(bgs, im.shape[1], im.shape[2])
    diff = fg - bg
    qualify = local_max & _edge_ok(im.shape, min_edge_distance, im.device)
    th_t = torch.tensor(th, dtype=torch.float32, device=im.device)
    frac = 1.0 - diff / th_t
    level = torch.ceil(frac[qualify] * float(n_lvl)).clamp(0, n_lvl)
    counts = torch.bincount(level.to(torch.int64),
                            minlength=n_lvl + 1)[:n_lvl]
    qdiff = torch.where(qualify, diff, float("-inf"))
    return qdiff, counts.to(torch.int32)


def _check(t: torch.Tensor, name: str, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"seed_pyramid: {name} must be a CUDA tensor")
    if t.dtype != torch.float32:
        raise ValueError(f"seed_pyramid: {name} must be float32, "
                         f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"seed_pyramid: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"seed_pyramid: {name} must be contiguous")


def fused_seed_classify_pyramid_cuda(im: torch.Tensor, bgs: torch.Tensor,
                                     k_fg: np.ndarray, th: float,
                                     n_lvl: int, min_edge_distance: int
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/seed_pyramid.cu`` on the current stream."""
    global launches
    if im.ndim != 3:
        raise ValueError(f"seed_pyramid: im must be (Z, X, Y), got "
                         f"{tuple(im.shape)}")
    z, x, y = im.shape
    if x % 4 or y % 4:
        raise ValueError(f"seed_pyramid: X and Y must be multiples of 4, "
                         f"got {tuple(im.shape)}")
    _check(im, "im", (z, x, y))
    _check(bgs, "bgs", (z, x // 4, y // 4))
    r = len(k_fg) // 2
    if r > MAX_FG_RADIUS or not 1 <= n_lvl <= MAX_LEVELS:
        raise ValueError(f"seed_pyramid: fg radius {r} (max "
                         f"{MAX_FG_RADIUS}) / n_lvl {n_lvl} (max "
                         f"{MAX_LEVELS}) out of range")
    taps = torch.as_tensor(np.asarray(k_fg, np.float32), device=im.device)
    qdiff = torch.empty_like(im)
    counts = torch.zeros(n_lvl, dtype=torch.int32, device=im.device)
    lib = _build.load("seed_pyramid")
    fn = lib.seed_pyramid_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
        + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    rc = fn(im.data_ptr(), bgs.data_ptr(), taps.data_ptr(),
            qdiff.data_ptr(), counts.data_ptr(), z, x, y, r, float(th),
            int(n_lvl), int(min_edge_distance),
            torch.cuda.current_stream(im.device).cuda_stream)
    if rc != 0:
        err = lib.ia3_cuda_error_string
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"seed_pyramid kernel launch failed: "
                           f"{err(rc).decode()} ({rc})")
    launches += 1
    return qdiff, counts


def pyramid_supported(shape, gfilt_size: float, background_gfilt_size: float,
                      filt_size: int, min_edge_distance: int) -> bool:
    """Whether the pyramid classifier takes this config (the JAX package's
    semantic conditions; the TPU-only tiling gates are not copied)."""
    if not (gfilt_size and background_gfilt_size):
        return False
    r_fg = int(4.0 * float(gfilt_size) + 0.5)
    return (filt_size == 3 and min_edge_distance >= 1 and shape[0] >= 2
            and r_fg <= MAX_FG_RADIUS
            and shape[1] % 4 == 0 and shape[2] % 4 == 0)


def fused_seed_classify_pyramid(im: torch.Tensor, sigma_fg: float,
                                sigma_bg: float, th_seed, n_lvl: int,
                                min_edge_distance: int = 2
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pyramid-background classifier -> (qdiff, counts): the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    imf = im.to(torch.float32).contiguous()
    if not pyramid_supported(imf.shape, sigma_fg, sigma_bg, 3,
                             min_edge_distance):
        raise ValueError("fused_seed_classify_pyramid: unsupported "
                         f"shape/config {tuple(imf.shape)}, sigma_fg "
                         f"{sigma_fg}, min_edge_distance "
                         f"{min_edge_distance}")
    k_fg = gaussian_kernel1d(sigma_fg)
    th = float(max(np.float32(float(th_seed)), np.float32(1e-6)))
    bgs = pyramid_background(imf, sigma_bg)
    if imf.is_cuda:
        return fused_seed_classify_pyramid_cuda(imf, bgs, k_fg, th, n_lvl,
                                                min_edge_distance)
    if imf.device.type != "cpu":
        raise ValueError(f"seed_pyramid: no kernel for device {imf.device}")
    return fused_seed_classify_pyramid_plain(imf, bgs, k_fg, th, n_lvl,
                                             min_edge_distance)
