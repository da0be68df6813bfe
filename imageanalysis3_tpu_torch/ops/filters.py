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

from contextlib import contextmanager
from functools import lru_cache
from typing import Sequence, Union

import numpy as np
import torch

from ..device import device_constant


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


def _map_boundary_index(idx, n: int, mode: str) -> np.ndarray:
    """Map (arrays of) out-of-range indices to source indices per scipy
    boundary mode; -1 means no contribution (mode='constant')."""
    idx = np.asarray(idx, np.int64)
    if mode == "constant":
        return np.where((idx >= 0) & (idx < n), idx, -1)
    if mode == "wrap":
        return idx % n
    if mode not in ("nearest", "reflect", "mirror"):
        raise ValueError(mode)
    for _ in range(64):  # repeated reflection for radius > n
        lo, hi = idx < 0, idx >= n
        if not (lo.any() or hi.any()):
            break
        if mode == "nearest":
            idx = np.clip(idx, 0, n - 1)
        elif mode == "reflect":       # scipy 'reflect' = symmetric: 1,0|0,1
            idx = np.where(lo, -idx - 1, np.where(hi, 2 * n - 1 - idx, idx))
        else:                         # scipy 'mirror' = reflect-101: 1|0|1
            idx = np.where(lo, -idx, np.where(hi, 2 * n - 2 - idx, idx))
    return np.clip(idx, 0, n - 1)


@lru_cache(maxsize=256)
def _band_matrix(n: int, kernel_key: tuple, mode: str) -> np.ndarray:
    """(n, n) matrix W with out = W @ x == correlate1d(x, kernel, mode)."""
    kernel = np.asarray(kernel_key, np.float64)
    k = len(kernel)
    rows = np.repeat(np.arange(n), k)
    taps = np.tile(np.arange(k), n)
    src = _map_boundary_index(rows + taps - k // 2, n, mode)
    keep = src >= 0
    w = np.zeros((n, n), np.float64)
    # unbuffered, in (row, tap) order: the sums of the per-element loop
    np.add.at(w, (rows[keep], src[keep]), kernel[taps[keep]])
    return w.astype(np.float32)


@contextmanager
def full_f32_matmul():
    """Run float32 matrix products in full float32 inside the block, not
    TF32, whatever the caller set, and restore the caller's setting after,
    through the API the caller used: PyTorch refuses to read its legacy
    ``allow_tf32`` flag once the newer ``fp32_precision`` one was set."""
    flags = torch.backends.cuda.matmul
    try:
        prev = flags.allow_tf32
    except RuntimeError:
        prev = None
    if prev is None:
        prev_precision = flags.fp32_precision
        flags.fp32_precision = "ieee"
        try:
            yield
        finally:
            flags.fp32_precision = prev_precision
    else:
        flags.allow_tf32 = False
        try:
            yield
        finally:
            flags.allow_tf32 = prev


@contextmanager
def full_f32_conv():
    """Run float32 cuDNN convolutions, and matrix products, in full
    float32 inside the block: :func:`full_f32_matmul`, and the same for
    cuDNN, whose ``allow_tf32`` is True by default."""
    flags = torch.backends.cudnn
    try:
        prev = flags.allow_tf32
    except RuntimeError:
        prev = None
    with full_f32_matmul():
        if prev is None:
            prev_precision = flags.conv.fp32_precision
            flags.conv.fp32_precision = "ieee"
            try:
                yield
            finally:
                flags.conv.fp32_precision = prev_precision
        else:
            flags.allow_tf32 = False
            try:
                yield
            finally:
                flags.allow_tf32 = prev


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
    idx = device_constant(
        ("pad_index", n, lo, hi, mode), torch.int64, im.device,
        lambda: _map_boundary_index(np.arange(-lo, n + hi), n, mode))
    return im.index_select(axis, idx)


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
    shift-add for few taps (k <= 9), else one full-f32 matmul with the
    (n, n) band matrix (boundary modes folded in)."""
    kernel = np.asarray(kernel, np.float32)
    k = kernel.shape[0]
    n = im.shape[axis]
    if k <= 9 and n > k:
        return _shift_add(im, kernel, axis, mode)
    taps = tuple(kernel.tolist())
    w = device_constant(("band_matrix", n, taps, mode), torch.float32,
                        im.device, lambda: _band_matrix(n, taps, mode))
    moved = im.movedim(axis, -1)
    with full_f32_matmul():
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


def gaussian_deconvolution(im: torch.Tensor, gfilt_size: float = 2.0,
                           niter: int = 1) -> torch.Tensor:
    """Naive deconvolution: `niter` times, divide by the image's own
    Gaussian blur (reference correction_tools/filter.py:4-11)."""
    out = im.to(torch.float32)
    for _ in range(niter):
        out = out / gaussian_filter(out, gfilt_size)
    return out


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


def nanquantile(x: torch.Tensor, q: float, dim=None) -> torch.Tensor:
    """NaN-ignoring linear quantile of float `x` over `dim` (None = all),
    with the arithmetic of ``jnp.nanquantile``: sort (NaN last), position
    f32(q) * (count - 1), then low * (1 - w) + high * w in f32; NaN where
    nothing is finite.  So the median of an even count averages the two
    middle values (``torch.nanmedian`` returns the lower one), and there
    is no element limit (``torch.nanquantile`` refuses more than 2**24).
    `dim` may be a tuple of trailing dims."""
    if dim is None:
        x, dim = x.reshape(-1), 0
    elif isinstance(dim, tuple):
        dims = sorted(d % x.ndim for d in dim)
        if dims != list(range(x.ndim - len(dims), x.ndim)):
            raise ValueError(f"nanquantile reduces trailing dims, got {dim}")
        x, dim = x.flatten(dims[0]), dims[0]
    s = torch.sort(x, dim=dim).values
    n = (~torch.isnan(s)).sum(dim=dim, keepdim=True, dtype=torch.float32)
    pos = torch.tensor(q, dtype=torch.float32, device=x.device) * (n - 1.0)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w_hi = pos - lo
    lo = torch.minimum(lo, n - 1.0).clamp_min(0.0).long()
    hi = torch.minimum(hi, n - 1.0).clamp_min(0.0).long()
    out = (s.gather(dim, lo) * (1.0 - w_hi) + s.gather(dim, hi) * w_hi)
    return out.squeeze(dim)


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
