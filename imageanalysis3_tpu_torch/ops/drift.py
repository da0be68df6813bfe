"""Drift registration: batched FFT phase correlation with subpixel DFT.

The counterpart of ``imageanalysis3_tpu/ops/drift.py``.  Behavior targets
(reference ImageAnalysis3):
  * subpixel phase correlation      correction_tools/alignment.py:419-500
    (skimage.registration.phase_cross_correlation, upsample_factor=100)
  * 8-crop consensus aligner        correction_tools/alignment.py:527-695
  * crop generation                 correction_tools/alignment.py:87-135

Every function takes one (Z, X, Y) view or a batch (K, Z, X, Y) of crops;
the FFTs run over the last three dims and the Guizar-Sicairos subpixel
refinement is three complex64 matrix products per stage.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

_DIMS = (-3, -2, -1)


def _axis_kernel(n: int, npoints: int, center: torch.Tensor,
                 upsample: float) -> torch.Tensor:
    """(K, npoints, n) complex DFT evaluation kernels for one axis.

    W[k, j, f] = exp(2*pi*i * freq_f * (center_k + (j - m)/upsample) / n)
    with freq_f the signed integer FFT frequencies of a length-n axis, so
    (W @ R) evaluates the inverse DFT of spectrum R on a grid of `npoints`
    samples spaced 1/upsample around `center`.
    """
    dev = center.device
    m = npoints // 2
    freqs = torch.fft.fftfreq(n, d=1.0 / n, device=dev).to(torch.float32)
    offs = (torch.arange(npoints, device=dev, dtype=torch.float32) - m) \
        / upsample
    s = center[:, None] + offs[None, :]                        # (K, np)
    two_pi = torch.tensor(2 * math.pi, dtype=torch.float32, device=dev)
    theta = (two_pi * s)[..., None] * freqs / n
    return torch.polar(torch.ones_like(theta), theta)


def _upsampled_argmax(R: torch.Tensor, ny_full: int, center: torch.Tensor,
                      upsample: float, npoints: int) -> torch.Tensor:
    """argmax of |IDFT(R)| on a fine grid around `center` (K, 3).

    `R` (K, nz, nx, ny_full//2+1) is the rFFT half-spectrum: for real
    inputs the cross-spectrum is Hermitian, so the real correlation equals
    Re(sum over the half spectrum) with weight 2 on the interior y
    frequencies (1 on DC and, for even ny, Nyquist).
    """
    k, nz, nx, ny_half = R.shape
    dev = R.device
    Wz = _axis_kernel(nz, npoints, center[:, 0], upsample)
    Wx = _axis_kernel(nx, npoints, center[:, 1], upsample)
    m = npoints // 2
    freqs_y = torch.arange(ny_half, dtype=torch.float32, device=dev)
    offs = (torch.arange(npoints, device=dev, dtype=torch.float32) - m) \
        / upsample
    s = center[:, 2, None] + offs[None, :]
    two_pi = torch.tensor(2 * math.pi, dtype=torch.float32, device=dev)
    theta = (two_pi * s)[..., None] * freqs_y / ny_full
    w = torch.full((ny_half,), 2.0, device=dev)
    w[0] = 1.0
    if ny_full % 2 == 0:
        w[-1] = 1.0
    Wy = torch.polar(torch.ones_like(theta), theta) * w
    t = torch.einsum("kaz,kzxy->kaxy", Wz, R)
    t = torch.einsum("kbx,kaxy->kaby", Wx, t)
    t = torch.einsum("kcy,kaby->kabc", Wy, t)
    mag = t.real.abs().reshape(k, -1)
    flat = mag.argmax(dim=1)
    idx = torch.stack([flat // (npoints * npoints),
                       (flat // npoints) % npoints,
                       flat % npoints], dim=1).to(torch.float32)
    return center + (idx - m) / upsample


def _condition_view(x: torch.Tensor, subtract_mean: bool,
                    window: Optional[str]) -> torch.Tensor:
    """Mean-subtract and taper each (Z, X, Y) view (last three dims)."""
    x = x.to(torch.float32)
    if subtract_mean:
        x = x - x.mean(dim=_DIMS, keepdim=True)
    if window is not None:
        axes = (-2, -1) if window == "hann_xy" else _DIMS
        for ax in axes:
            n = x.shape[ax]
            i = torch.arange(n, device=x.device, dtype=torch.float32)
            h = 0.5 - 0.5 * torch.cos(2 * math.pi * i / (n - 1))
            shape_b = [1] * x.ndim
            shape_b[ax] = n
            x = x * h.reshape(shape_b)
    return x


def prepare_ref_spectrum(ref: torch.Tensor, subtract_mean: bool = False,
                         window: Optional[str] = None) -> torch.Tensor:
    """Conditioned rFFT spectrum of a reference view (or batch of views).

    Every hyb round registers against the same reference round, so its
    crop spectra are computed once per FOV.
    """
    return torch.fft.rfftn(_condition_view(ref, subtract_mean, window),
                           dim=_DIMS)


def _phase_correlate_spectrum(F_ref, F_mov, shape, upsample_factor,
                              normalization, stages) -> torch.Tensor:
    """(K, 3) shifts from batched spectra of views of `shape` (Z, X, Y)."""
    R = F_ref * torch.conj(F_mov)
    if normalization == "phase":
        R = R / R.abs().clamp_min(1e-20)
    cc = torch.fft.irfftn(R, s=tuple(shape), dim=_DIMS).abs()
    k = cc.shape[0]
    flat = cc.reshape(k, -1).argmax(dim=1)
    z, x, y = shape
    peak = torch.stack([flat // (x * y), (flat // y) % x, flat % y],
                       dim=1).to(torch.float32)
    size = torch.tensor(shape, dtype=torch.float32, device=cc.device)
    shift = torch.where(peak > size / 2, peak - size, peak)
    if upsample_factor <= 1:
        return shift
    if stages is None:
        # chain 10x stages until the product covers upsample_factor; the
        # last stage uses the exact remaining factor
        stages, total = [], 1
        while total < upsample_factor:
            u = min(10, int(np.ceil(upsample_factor / total)))
            stages.append(u)
            total *= u
    total = 1.0
    est = shift
    for u in stages:
        total *= u
        # grid must cover +-(1/previous_resolution)/2 with margin
        npoints = int(2 * np.ceil(0.75 * u)) + 1
        est = _upsampled_argmax(R, shape[-1], est, total, npoints)
        if total >= upsample_factor:
            break
    return est


def _batched(fn, view: torch.Tensor, *args):
    """Run a batched (K, Z, X, Y) function on one 3D view too."""
    if view.ndim == 3:
        return fn(view[None], *(a[None] for a in args))[0]
    return fn(view, *args)


def subpixel_phase_correlation_prepared(
        F_ref: torch.Tensor, mov: torch.Tensor,
        upsample_factor: int = 100,
        normalization: Optional[str] = None,
        stages: Optional[Tuple[int, ...]] = None,
        subtract_mean: bool = False,
        window: Optional[str] = None) -> torch.Tensor:
    """Shift (zxy, px) registering `mov` onto the reference whose spectrum
    is `F_ref` (see :func:`prepare_ref_spectrum`).  skimage's convention:
    if ``mov(x) = ref(x - s)`` the result is ``-s``."""
    def run(mov_b, f_ref_b):
        mov_b = _condition_view(mov_b, subtract_mean, window)
        F_mov = torch.fft.rfftn(mov_b, dim=_DIMS)
        return _phase_correlate_spectrum(f_ref_b, F_mov, mov_b.shape[-3:],
                                         upsample_factor, normalization,
                                         stages)

    return _batched(run, mov, F_ref)


def subpixel_phase_correlation(ref: torch.Tensor, mov: torch.Tensor,
                               upsample_factor: int = 100,
                               normalization: Optional[str] = None,
                               stages: Optional[Tuple[int, ...]] = None,
                               subtract_mean: bool = False,
                               window: Optional[str] = None
                               ) -> torch.Tensor:
    """Shift (zxy, px) required to register `mov` onto `ref`."""
    return subpixel_phase_correlation_prepared(
        prepare_ref_spectrum(ref, subtract_mean=subtract_mean,
                             window=window),
        mov, upsample_factor, normalization, stages, subtract_mean, window)


# ---------------------------------------------------------------------------
# Crop-consensus aligner
# ---------------------------------------------------------------------------


def generate_drift_crops(image_size: Sequence[int],
                         drift_size: Optional[int] = None) -> np.ndarray:
    """Eight fixed-size crop boxes around the image center, (8, 3, 2) int.

    Crop centers follow reference correction_tools/alignment.py:87-135;
    every crop has identical shape so the batch registers at once.
    """
    sz = np.array(image_size, dtype=int)
    if drift_size is None:
        drift_size = int(np.max(sz) / 4)
    sel = sz / 2.0
    cts = np.array([
        [sel[0] / 2, sel[1] / 2, sel[2] / 2],
        [sel[0] / 2, (sel[1] + sz[1]) / 2, (sel[2] + sz[2]) / 2],
        [sel[0] / 2, (sel[1] + sz[1]) / 2, sel[2] / 2],
        [sel[0] / 2, sel[1] / 2, (sel[2] + sz[2]) / 2],
        [sel[0] / 2, sel[1], sel[2] / 2],
        [sel[0] / 2, sel[1], (sel[2] + sz[2]) / 2],
        [sel[0] / 2, sel[1] / 2, sel[2]],
        [sel[0] / 2, (sel[1] + sz[1]) / 2, sel[2]],
    ])
    half = np.minimum(np.full(3, drift_size / 2.0), sz / 2.0)
    crop_shape = np.minimum(np.full(3, drift_size, dtype=int), sz)
    boxes = []
    for ct in cts:
        lo = np.clip(np.round(ct - half).astype(int), 0, sz - crop_shape)
        boxes.append(np.stack([lo, lo + crop_shape], axis=1))
    return np.array(boxes)


def consensus_drift(drifts: torch.Tensor, drift_diff_th: float = 1.0,
                    min_good_drifts: int = 3
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vote over per-crop drifts (K, 3) -> (consensus drift, flag).

    flag 0: some drift has >= min_good_drifts crops (itself included) within
    drift_diff_th of it -- return the mean of that agreeing group; flag 1:
    the mean of the mutually closest 3 drifts (reference
    correction_tools/alignment.py:664-695).
    """
    drifts = drifts.to(torch.float32)
    k = drifts.shape[0]
    d2 = ((drifts[:, None] - drifts[None, :]) ** 2).sum(dim=-1)
    agree = d2 <= drift_diff_th ** 2       # includes self (diagonal)
    counts = agree.to(torch.int32).sum(dim=1)
    best = counts.argmax()
    n_good = counts[best]
    group = agree[best]
    good_mean = torch.where(group[:, None], drifts, 0.0).sum(dim=0) \
        / n_good.to(torch.float32).clamp_min(1.0)
    eye = torch.eye(k, dtype=torch.bool, device=drifts.device)
    d2 = torch.where(eye, float("inf"), d2)
    pair_flat = d2.reshape(-1).argmin()
    i, j = pair_flat // k, pair_flat % k
    third_score = d2[:, i] + d2[:, j]
    third_score[i] = float("inf")
    third_score[j] = float("inf")
    t = third_score.argmin()
    # times the f32 reciprocal: the product XLA evaluates for the JAX
    # package's `/ 3.0`, so both packages give the same bits
    fallback = (drifts[i] + drifts[j] + drifts[t]) * (1.0 / 3.0)
    ok = n_good >= min_good_drifts
    out = torch.where(ok, good_mean, fallback)
    flag = torch.where(ok, 0, 1).to(torch.int32)
    return out, flag
