"""Seed classifiers of the plain reference: the plain versions of the
port's seeding kernels (imageanalysis3_tpu_torch/ops/seed_kernels.py), which
run on any device.

Frozen at the port's commit 5edc061; edit only to fix the reference.  The CUDA wrappers are left out and
every entry takes its plain version.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .filters import (_band_matrix, _conv1d_along_axis, _shift_add,
                      _window_reduce, full_f32_matmul,
                      gaussian_kernel1d)


MAX_FG_RADIUS = 12     # seed_pyramid


MAX_RADIUS = 36        # seed_classify / dual_blur (csrc/seed_common.cuh)


MAX_LEVELS = 128


def _edge_ok(shape, d: int, device) -> torch.Tensor:
    z, x, y = shape
    zi = torch.arange(z, device=device)[:, None, None]
    xi = torch.arange(x, device=device)[None, :, None]
    yi = torch.arange(y, device=device)[None, None, :]
    return ((zi >= d) & (zi <= z - d) & (xi >= d) & (xi <= x - d)
            & (yi >= d) & (yi <= y - d))


def _levels(diff: torch.Tensor, th: float, n_lvl: int) -> torch.Tensor:
    """clip(ceil((1 - diff/th) n), 0, n) in the kernels' f32 arithmetic."""
    th_t = torch.tensor(th, dtype=torch.float32, device=diff.device)
    return torch.ceil((1.0 - diff / th_t) * float(n_lvl)).clamp(0, n_lvl)


def _histogram(level: torch.Tensor, n_lvl: int) -> torch.Tensor:
    return torch.bincount(level.to(torch.int64).reshape(-1),
                          minlength=n_lvl + 1)[:n_lvl].to(torch.int32)


def _clamped_th(th_seed) -> float:
    return float(max(np.float32(float(th_seed)), np.float32(1e-6)))


def _blur_xy(im: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """x then y 'reflect' pass by shift-add: the order the kernels sum in."""
    return _shift_add(_shift_add(im, kernel, 1, "reflect"), kernel, 2,
                      "reflect")


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
    return _blur_xy(_shift_add(im, kernel, 0, "reflect"), kernel)


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
    counts = _histogram(_levels(diff[qualify], th, n_lvl), n_lvl)
    return torch.where(qualify, diff, float("-inf")), counts


def _pyramid_kernel_takes(shape, gfilt_size: float,
                          min_edge_distance: int) -> bool:
    """What the pyramid classifier itself needs: a (Z >= 2, X, Y) stack with
    X, Y multiples of 4, edge margin >= 1, fg radius <= 12."""
    r_fg = int(4.0 * float(gfilt_size) + 0.5)
    return (len(shape) == 3 and shape[0] >= 2 and min_edge_distance >= 1
            and r_fg <= MAX_FG_RADIUS
            and shape[1] % 4 == 0 and shape[2] % 4 == 0)


def pyramid_supported(shape, gfilt_size: float, background_gfilt_size: float,
                      filt_size: int, min_edge_distance: int,
                      slab_x: int) -> bool:
    """Whether ``get_seeds`` takes the pyramid classifier for this config:
    the JAX package's semantic conditions, which include every condition of
    the exact fused classifier (:func:`fused_supported`: both radii <= 36,
    ``x <= 2 * slab_x``); the TPU-only tiling gates are not copied."""
    return (fused_supported(shape, gfilt_size, background_gfilt_size,
                            filt_size, min_edge_distance, slab_x)
            and _pyramid_kernel_takes(shape, gfilt_size, min_edge_distance))


def fused_seed_classify_pyramid(im: torch.Tensor, sigma_fg: float,
                                sigma_bg: float, th_seed, n_lvl: int,
                                min_edge_distance: int = 2
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pyramid-background classifier -> (qdiff, counts): the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    imf = im.to(torch.float32).contiguous()
    if not (sigma_fg and sigma_bg
            and _pyramid_kernel_takes(imf.shape, sigma_fg, min_edge_distance)):
        raise ValueError("fused_seed_classify_pyramid: unsupported "
                         f"shape/config {tuple(imf.shape)}, sigma_fg "
                         f"{sigma_fg}, min_edge_distance "
                         f"{min_edge_distance}")
    k_fg = gaussian_kernel1d(sigma_fg)
    th = _clamped_th(th_seed)
    bgs = pyramid_background(imf, sigma_bg)
    return fused_seed_classify_pyramid_plain(imf, bgs, k_fg, th, n_lvl,
                                             min_edge_distance)


def z_pass_pair(im: torch.Tensor, k_fg: np.ndarray, k_bg: np.ndarray
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both 'reflect' z passes as ONE f32 banded matmul (2Z, Z) @ (Z, X*Y),
    the einsum the JAX package runs outside its kernel -> (fgz, bgz), two
    contiguous (Z, X, Y) views of one (2, Z, X, Y) buffer.  The product
    runs in full f32 whatever the caller's TF32 setting."""
    z, x, y = im.shape
    w = np.concatenate([_band_matrix(z, tuple(k_fg.tolist()), "reflect"),
                        _band_matrix(z, tuple(k_bg.tolist()), "reflect")])
    w = torch.from_numpy(w).to(im.device)
    with full_f32_matmul():
        out = torch.matmul(w, im.reshape(z, x * y)).reshape(2, z, x, y)
    return out[0], out[1]


def fused_seed_classify_plain(fgz: torch.Tensor, bgz: torch.Tensor,
                              k_fg: np.ndarray, k_bg: np.ndarray, th: float,
                              n_lvl: int, min_edge_distance: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``csrc/seed_classify.cu`` on the same
    z-passed inputs -> (qdiff (Z, X, Y) f32, counts (n_lvl,) int32)."""
    return classify_blurred(_blur_xy(fgz, k_fg), _blur_xy(bgz, k_bg), th,
                            n_lvl, min_edge_distance)


def classify_blurred(fg: torch.Tensor, bg: torch.Tensor, th: float,
                     n_lvl: int, min_edge_distance: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact classifier's in-range 3^3 stencil and level histogram on
    two blurred stacks -> (qdiff, counts)."""
    local_max = ((_window_reduce(fg, 3, "constant", "max") == fg)
                 & (_window_reduce(bg, 3, "constant", "min") != bg))
    diff = fg - bg
    qualify = local_max & _edge_ok(fg.shape, min_edge_distance, fg.device)
    counts = _histogram(_levels(diff[qualify], th, n_lvl), n_lvl)
    return torch.where(qualify, diff, float("-inf")), counts


def fused_supported(shape, gfilt_size: float, background_gfilt_size: float,
                    filt_size: int, min_edge_distance: int,
                    slab_x: int) -> bool:
    """Whether the exact fused classifier takes this config (the JAX
    package's semantic conditions, without its TPU tiling gates)."""
    if not (gfilt_size and background_gfilt_size):
        return False
    r = max(int(4.0 * float(s) + 0.5)
            for s in (gfilt_size, background_gfilt_size))
    return (filt_size == 3 and min_edge_distance >= 1 and shape[0] >= 2
            and r <= MAX_RADIUS and shape[1] <= 2 * slab_x)


def fused_seed_classify(im: torch.Tensor, sigma_fg: float, sigma_bg: float,
                        th_seed, n_lvl: int, min_edge_distance: int = 2
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact seeding classifier -> (qdiff, counts): z passes as one banded
    matmul, then the CUDA kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    imf = im.to(torch.float32).contiguous()
    if min_edge_distance < 1 or imf.ndim != 3 or imf.shape[0] < 2:
        raise ValueError("fused_seed_classify: needs a (Z >= 2, X, Y) stack "
                         f"and min_edge_distance >= 1, got "
                         f"{tuple(imf.shape)}, {min_edge_distance}")
    k_fg, k_bg = gaussian_kernel1d(sigma_fg), gaussian_kernel1d(sigma_bg)
    th = _clamped_th(th_seed)
    fgz, bgz = z_pass_pair(imf, k_fg, k_bg)
    return fused_seed_classify_plain(fgz, bgz, k_fg, k_bg, th, n_lvl, min_edge_distance)


def dual_blur_xy_plain(fgz: torch.Tensor, bgz: torch.Tensor,
                       k_fg: np.ndarray, k_bg: np.ndarray
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``csrc/dual_blur.cu``: the x then y
    'reflect' passes of each z-passed stack, taps in order.  The kernel's
    fg equals it bit for bit; for the default taps (:data:`MMA_TAPS`) its
    bg is the banded split-TF32 product (arithmetic model
    :func:`blur_xy_split_tf32_plain`), within the JAX tests' rtol 2e-5 /
    atol 2e-2 of this one."""
    return _blur_xy(fgz, k_fg), _blur_xy(bgz, k_bg)


def dual_gaussian_blur(im: torch.Tensor, sigma_fg: float, sigma_bg: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gaussian(im, sigma_fg), gaussian(im, sigma_bg)), scipy 'reflect':
    the z passes as filters._conv1d_along_axis (as the JAX wrapper does),
    then the CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    imf = im.to(torch.float32)
    k_fg, k_bg = gaussian_kernel1d(sigma_fg), gaussian_kernel1d(sigma_bg)
    fgz = _conv1d_along_axis(imf, k_fg, 0, "reflect").contiguous()
    bgz = _conv1d_along_axis(imf, k_bg, 0, "reflect").contiguous()
    return dual_blur_xy_plain(fgz, bgz, k_fg, k_bg)


