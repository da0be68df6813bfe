"""Separable filters and robust statistics on 3D stacks, in plain PyTorch.

The counterpart of ``imageanalysis3_tpu/ops/filters.py``: the scipy.ndimage
primitives the reference leans on (``gaussian_filter``, ``maximum_filter``,
``minimum_filter``) as separable 1D passes along each axis.

Boundary-mode naming follows scipy.ndimage:
  * ``"nearest"``  -> edge replication
  * ``"reflect"``  -> symmetric (1,0|0,1)
  * ``"mirror"``   -> reflect-101 (1|0|1)

Every boundary is applied through :func:`_map_boundary_index`, the same
repeated-reflection index map the JAX package folds into its band matrices,
so short axes (radius > n) behave identically.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Union

import numpy as np
import torch


def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """Discrete Gaussian kernel identical to scipy.ndimage's construction.

    radius = int(truncate * sigma + 0.5); weights exp(-0.5 x^2/sigma^2),
    normalized to sum 1.
    """
    radius = int(float(truncate) * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    w = np.exp(-0.5 * (x / float(sigma)) ** 2)
    w /= w.sum()
    return w.astype(np.float32)


def _map_boundary_index(idx: int, n: int, mode: str) -> int:
    """Map an out-of-range index to a source index per scipy boundary mode
    (None = no contribution, for mode='constant')."""
    if mode == "constant":
        return idx if 0 <= idx < n else None
    if mode == "wrap":
        return idx % n
    for _ in range(64):  # repeated reflection for radius > n
        if 0 <= idx < n:
            return idx
        if mode == "nearest":
            idx = min(max(idx, 0), n - 1)
        elif mode == "reflect":       # scipy 'reflect' = symmetric: 1,0|0,1
            idx = -idx - 1 if idx < 0 else 2 * n - 1 - idx
        elif mode == "mirror":        # scipy 'mirror' = reflect-101: 1|0|1
            idx = -idx if idx < 0 else 2 * n - 2 - idx
        else:
            raise ValueError(mode)
    return min(max(idx, 0), n - 1)


@lru_cache(maxsize=256)
def _band_matrix(n: int, kernel_key: tuple, mode: str) -> np.ndarray:
    """(n, n) matrix W with out = W @ x == correlate1d(x, kernel, mode)."""
    kernel = np.asarray(kernel_key, np.float64)
    k = len(kernel)
    radius = k // 2
    w = np.zeros((n, n), np.float64)
    for i in range(n):
        for t in range(k):
            s = _map_boundary_index(i + t - radius, n, mode)
            if s is not None:
                w[i, s] += kernel[t]
    return w.astype(np.float32)


def _pad_axis(im: torch.Tensor, axis: int, lo: int, hi: int,
              mode: str, fill: float = 0.0) -> torch.Tensor:
    """Pad `im` along `axis` by (lo, hi) with scipy boundary `mode`
    ('constant' pads with `fill`)."""
    n = im.shape[axis]
    if mode == "constant":
        shape = list(im.shape)
        shape[axis] = n + lo + hi
        out = torch.full(shape, fill, dtype=im.dtype, device=im.device)
        out.narrow(axis, lo, n).copy_(im)
        return out
    idx = [_map_boundary_index(i, n, mode) for i in range(-lo, n + hi)]
    return im.index_select(axis, torch.tensor(idx, device=im.device))


def _shift_add(im: torch.Tensor, kernel: np.ndarray, axis: int,
               mode: str) -> torch.Tensor:
    """Correlate along `axis` by padded shift-multiply-add: each tap one
    rounded product and one rounded sum, in tap order (the arithmetic the
    seeding kernel reproduces bit for bit)."""
    n = im.shape[axis]
    radius = len(kernel) // 2
    padded = _pad_axis(im, axis, radius, radius, mode)
    out = padded.narrow(axis, 0, n) * float(kernel[0])
    for t in range(1, len(kernel)):
        out = out + padded.narrow(axis, t, n) * float(kernel[t])
    return out


def _conv1d_along_axis(im: torch.Tensor, kernel: np.ndarray, axis: int,
                       mode: str) -> torch.Tensor:
    """Correlate `im` with 1D `kernel` along `axis` (scipy boundary mode):
    shift-add for few taps (k <= 9), else one f32 matmul with the (n, n)
    band matrix (boundary modes folded in)."""
    kernel = np.asarray(kernel, np.float32)
    k = kernel.shape[0]
    n = im.shape[axis]
    if k <= 9 and n > k:
        return _shift_add(im, kernel, axis, mode)
    w = torch.from_numpy(_band_matrix(n, tuple(kernel.tolist()), mode)
                         ).to(im.device)
    moved = im.movedim(axis, -1)
    return torch.matmul(moved, w.T).movedim(-1, axis)


def gaussian_filter(im: torch.Tensor,
                    sigma: Union[float, Sequence[float]],
                    truncate: float = 4.0,
                    mode: str = "reflect",
                    axes: Sequence[int] | None = None) -> torch.Tensor:
    """scipy.ndimage.gaussian_filter parity, as separable 1D passes.

    The seeding blurs use the default mode="reflect"; the high-pass filter
    uses mode="nearest", truncate=2.
    """
    im = im.to(torch.float32)
    if axes is None:
        axes = tuple(range(im.ndim))
    if np.isscalar(sigma):
        sigmas = [float(sigma)] * len(axes)
    else:
        sigmas = [float(s) for s in sigma]
    out = im
    for ax, s in zip(axes, sigmas):
        if s <= 0:
            continue
        out = _conv1d_along_axis(out, gaussian_kernel1d(s, truncate), ax,
                                 mode)
    return out


def _window_reduce(im: torch.Tensor, size: int, mode: str,
                   op: str) -> torch.Tensor:
    """Separable min/max filter along every axis, boundary per `mode`
    ('constant' pads with the reduction's identity, -inf for max)."""
    pad_lo = size // 2
    pad_hi = size - 1 - pad_lo
    fn = torch.maximum if op == "max" else torch.minimum
    fill = float("-inf") if op == "max" else float("inf")
    out = im.to(torch.float32)
    for ax in range(im.ndim):
        n = out.shape[ax]
        padded = _pad_axis(out, ax, pad_lo, pad_hi, mode, fill)
        acc = padded.narrow(ax, 0, n)
        for t in range(1, size):
            acc = fn(acc, padded.narrow(ax, t, n))
        out = acc
    return out


def _window_reduce_interior(im: torch.Tensor, size: int,
                            op: str) -> torch.Tensor:
    """Min/max filter exact on interior voxels only: border voxels see the
    reduction's identity instead of reflected neighbors.  Callers that
    discard a >= size//2 border get identical results."""
    return _window_reduce(im, size, "constant", op)


def maximum_filter(im: torch.Tensor, size: int = 3,
                   mode: str = "reflect") -> torch.Tensor:
    """scipy.ndimage.maximum_filter parity (cubic window, separable)."""
    return _window_reduce(im, size, mode, "max")


def minimum_filter(im: torch.Tensor, size: int = 3,
                   mode: str = "reflect") -> torch.Tensor:
    """scipy.ndimage.minimum_filter parity (cubic window, separable)."""
    return _window_reduce(im, size, mode, "min")


def gaussian_highpass(im: torch.Tensor, sigma: float = 5.0,
                      truncate: float = 2.0) -> torch.Tensor:
    """High-pass: im - lowpass, zeroed where lowpass > im (reference
    correction_tools/filter.py:14-19, mode="nearest")."""
    imf = im.to(torch.float32)
    lowpass = gaussian_filter(imf, sigma, truncate=truncate, mode="nearest")
    return torch.where(lowpass > imf, torch.zeros_like(imf), imf - lowpass)


# ---------------------------------------------------------------------------
# Medians: binary search over the quarter-integer value domain with counting
# passes instead of a sort -- exact for uint16 camera data.
# ---------------------------------------------------------------------------

_SCALE = 4.0


def counting_median(im: torch.Tensor, bits: int = 18,
                    axis=None) -> torch.Tensor:
    """Median via binary search over a fixed-point value domain.

    Exact for inputs on a 1/4-integer grid within [0, 2**16) when
    ``bits=18``.  `axis` reduces over those axes (None = all).  Returns
    the lower median m = min{v : count(im <= v) >= ceil(N/2)}.
    """
    imf = im.to(torch.float32)
    if axis is None:
        axis = tuple(range(im.ndim))
    elif isinstance(axis, int):
        axis = (axis,)
    n = 1
    for ax in axis:
        n *= im.shape[ax]
    half = (n + 1) // 2
    codes = torch.floor(imf * _SCALE + 0.5).to(torch.int32)
    red_shape = [s for i, s in enumerate(im.shape) if i not in axis]
    lo = torch.zeros(red_shape, dtype=torch.int32, device=im.device)
    hi = lo + ((1 << bits) - 1)
    for _ in range(bits):
        mid = (lo + hi) >> 1
        mid_b = mid
        for ax in sorted(axis):
            mid_b = mid_b.unsqueeze(ax)
        cnt = (codes <= mid_b).sum(dim=axis, dtype=torch.int32)
        ok = cnt >= half
        lo, hi = torch.where(ok, lo, mid + 1), torch.where(ok, mid, hi)
    return lo.to(torch.float32) / _SCALE


def counting_median_layers_and_global(im: torch.Tensor, bits: int = 18,
                                      subsample: int = 1):
    """(per-z-layer medians, global median) in ONE binary search.

    ``subsample`` = s > 1 searches every s-th full x-row; the result is the
    exact median of that sample.  s=1 keeps exact semantics.

    The JAX package stops its search once every interval is closed; here it
    runs a fixed `bits` iterations with no host synchronisation.  A closed
    interval (lo == hi) is a fixed point of the update, and codes of data in
    [0, 2**bits / 4) span fewer than 2**bits values, so `bits` halvings
    close every interval: the result is identical.
    """
    imf = im.to(torch.float32)
    if subsample > 1:
        imf = imf[:, ::subsample, :]
    n_layer = imf.shape[1] * imf.shape[2]
    half_layer = (n_layer + 1) // 2
    half_all = (imf.numel() + 1) // 2
    # floor(4x + 0.5) <= mid  <=>  x < (mid + 0.5) / 4, both sides exact in
    # f32, so no int32 code array is materialized
    code_of = lambda v: torch.floor(v * _SCALE + 0.5).to(torch.int32)
    lo_l = code_of(imf.amin(dim=(1, 2)))
    hi_l = code_of(imf.amax(dim=(1, 2)))
    lo_g = lo_l.min()
    hi_g = hi_l.max()
    for _ in range(bits):
        mid_l = (lo_l + hi_l) >> 1
        mid_g = (lo_g + hi_g) >> 1
        th_l = (mid_l.to(torch.float32) + 0.5) / _SCALE
        th_g = (mid_g.to(torch.float32) + 0.5) / _SCALE
        cnt_l = (imf < th_l[:, None, None]).sum(dim=(1, 2), dtype=torch.int32)
        cnt_g = (imf < th_g).sum(dtype=torch.int32)
        ok_l = cnt_l >= half_layer
        ok_g = cnt_g >= half_all
        lo_l, hi_l = (torch.where(ok_l, lo_l, mid_l + 1),
                      torch.where(ok_l, mid_l, hi_l))
        lo_g, hi_g = (torch.where(ok_g, lo_g, mid_g + 1),
                      torch.where(ok_g, mid_g, hi_g))
    return lo_l.to(torch.float32) / _SCALE, lo_g.to(torch.float32) / _SCALE
