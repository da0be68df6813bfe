"""Chromosome-trace conditioning: NaN-aware smoothing and interpolation.

The counterpart of ``imageanalysis3_tpu/analysis/traces.py``.  Behavior
targets (reference ImageAnalysis3):
  * ``nan_gaussian_filter``  domain_tools/__init__.py:5-20
    (normalized convolution: blur values and the finite-mask with the
    same Gaussian, take the ratio)
  * ``interp1dnan``          domain_tools/__init__.py:22-29
    (per-column np.interp over finite entries; constant end extension)
  * ``interpolate_chr``      domain_tools/__init__.py:31-47
    (optional per-axis NaN-aware smoothing, then linear interpolation
    anchored on rows with ALL coordinates finite, linearly extrapolated
    past the first/last anchor)
  * ``extract_sequences``    domain_tools/__init__.py:49-57

As in the JAX package, the smoothing is a float32 tensor program over
``ops.filters.gaussian_filter`` (scipy 'reflect' boundaries) on the
input's device, and the interpolators are host NumPy on (N ~ 1e2, 3)
traces, where a device round trip costs more than the arithmetic.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..device import as_tensor, host_array
from ..ops import filters


def nan_gaussian_filter(mat, sigma, keep_nan: bool = False,
                        truncate: float = 4.0, device=None) -> torch.Tensor:
    """Gaussian-blur ``mat`` ignoring NaNs (normalized convolution).

    Blurs the zero-filled values and the finite-support indicator with
    the same kernel and returns their ratio, so each output is the
    Gaussian-weighted mean of the finite entries in its window; where the
    window holds no finite entry the ratio is 0/0 = NaN.  ``keep_nan``
    re-masks the original NaN positions.  Any rank.  A tensor keeps its
    device; an array goes to `device` (default the card)."""
    m = as_tensor(mat, device).to(torch.float32)
    bad = torch.isnan(m)
    vv = filters.gaussian_filter(torch.where(bad, 0.0, m), sigma,
                                 truncate=truncate, mode="reflect")
    ww = filters.gaussian_filter(torch.where(bad, 0.0, 1.0), sigma,
                                 truncate=truncate, mode="reflect")
    z = vv / ww
    if keep_nan:
        z = torch.where(bad, float("nan"), z)
    return z


def _interp_linear_extrap(x: np.ndarray, xp: np.ndarray,
                          fp: np.ndarray) -> np.ndarray:
    """np.interp plus linear extrapolation from the end segments
    (scipy interp1d ``fill_value='extrapolate'`` semantics)."""
    y = np.interp(x, xp, fp)
    if len(xp) >= 2:
        lo = x < xp[0]
        if lo.any():
            s = (fp[1] - fp[0]) / (xp[1] - xp[0])
            y[lo] = fp[0] + (x[lo] - xp[0]) * s
        hi = x > xp[-1]
        if hi.any():
            s = (fp[-1] - fp[-2]) / (xp[-1] - xp[-2])
            y[hi] = fp[-1] + (x[hi] - xp[-1]) * s
    return y


def _host64(x) -> np.ndarray:
    return np.array(host_array(x), np.float64)


def interp1dnan(arr) -> np.ndarray:
    """Fill NaNs of a 1D array by linear interpolation between its finite
    entries (ends extend the nearest finite value, np.interp semantics)."""
    a = _host64(arr)
    bad = np.isnan(a)
    if bad.all() or not bad.any():
        return a
    idx = np.arange(len(a))
    a[bad] = np.interp(idx[bad], idx[~bad], a[~bad])
    return a


def interpolate_chr(zxy, gaussian: float = 0.0, device=None) -> np.ndarray:
    """Fill missing regions of a chromosome trace.

    ``zxy`` is (N, D) with NaN rows for undetected regions (an array or a
    tensor).  With ``gaussian > 0`` every column is first smoothed
    NaN-aware by :func:`nan_gaussian_filter` (on the tensor's device, or
    `device` for an array), which also diffuses values into short gaps.
    Rows where ALL coordinates are finite then anchor a per-column linear
    interpolation, linearly extrapolated beyond the first/last anchor.  A
    trace with no anchor rows is returned unchanged; a single anchor
    extends as a constant.  Returns float64 NumPy."""
    a = _host64(zxy)
    if a.ndim != 2:
        raise ValueError("interpolate_chr expects an (N, D) trace")
    if gaussian > 0:
        dev = zxy.device if isinstance(zxy, torch.Tensor) else device
        for i in range(a.shape[1]):
            a[:, i] = nan_gaussian_filter(a[:, i], gaussian,
                                          device=dev).cpu().numpy()
    ok = ~np.isnan(a).any(axis=1)
    if not ok.any():
        return a
    idx = np.arange(len(a), dtype=np.float64)
    out = np.empty_like(a)
    for i in range(a.shape[1]):
        out[:, i] = _interp_linear_extrap(idx, idx[ok], a[ok, i])
    return out


def extract_sequences(zxy, domain_starts: Sequence[int]) -> List[np.ndarray]:
    """Split a trace into per-domain coordinate blocks given domain start
    indices (last domain runs to the end)."""
    a = host_array(zxy)
    starts = np.asarray(domain_starts, np.int64)
    ends = np.append(starts[1:], len(a))
    return [a[s:e] for s, e in zip(starts, ends)]
