"""Drift registration: batched FFT phase correlation with subpixel DFT.

The counterpart of ``imageanalysis3_tpu/ops/drift.py``.  Behavior targets
(reference ImageAnalysis3):
  * subpixel phase correlation      correction_tools/alignment.py:419-500
    (skimage.registration.phase_cross_correlation, upsample_factor=100)
  * 8-crop consensus aligner        correction_tools/alignment.py:527-695
  * crop generation                 correction_tools/alignment.py:87-135
  * 2D-projection rough drift        alignment_tools.py:330-353
    (fft3d_from2d)

Every function takes one (Z, X, Y) view or a batch (K, Z, X, Y) of crops;
the FFTs run over the last three dims and the Guizar-Sicairos subpixel
refinement is three complex64 matrix products per stage.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import as_tensor, device_constant
from .filters import full_f32_matmul

_DIMS = (-3, -2, -1)


def _two_pi(dev) -> torch.Tensor:
    """2*pi as a float32 0-dim tensor on `dev`."""
    return device_constant(("two_pi",), torch.float32, dev,
                           lambda: 2 * math.pi)


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
    theta = (_two_pi(dev) * s)[..., None] * freqs / n
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
    theta = (_two_pi(dev) * s)[..., None] * freqs_y / ny_full

    def y_weights():
        w = torch.full((ny_half,), 2.0)
        w[0] = 1.0
        if ny_full % 2 == 0:
            w[-1] = 1.0
        return w

    w = device_constant(("dft_y_weights", ny_half, ny_full % 2),
                        torch.float32, dev, y_weights)
    Wy = torch.polar(torch.ones_like(theta), theta) * w
    # full f32 whatever the caller's TF32 setting (the reference: HIGHEST)
    with full_f32_matmul():
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
    size = device_constant(("size",) + tuple(shape), torch.float32,
                           cc.device, lambda: list(shape))
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
    # every index stays on the device: indexing by a 0-dim index tensor
    # would read it on the host
    best = counts.argmax().view(1)
    n_good = counts.index_select(0, best)[0]
    group = agree.index_select(0, best)[0]
    good_mean = torch.where(group[:, None], drifts, 0.0).sum(dim=0) \
        / n_good.to(torch.float32).clamp_min(1.0)
    eye = torch.eye(k, dtype=torch.bool, device=drifts.device)
    d2 = torch.where(eye, float("inf"), d2)
    pair_flat = d2.reshape(-1).argmin()
    ij = torch.stack([pair_flat // k, pair_flat % k])
    d2_ij = d2.index_select(1, ij)
    third_score = (d2_ij[:, 0] + d2_ij[:, 1]).index_fill_(0, ij,
                                                           float("inf"))
    t = third_score.argmin().view(1)
    di, dj, dt = drifts.index_select(0, torch.cat([ij, t]))
    # times the f32 reciprocal: the product XLA evaluates for the JAX
    # package's `/ 3.0`, so both packages give the same bits
    fallback = (di + dj + dt) * (1.0 / 3.0)
    ok = n_good >= min_good_drifts
    out = torch.where(ok, good_mean, fallback)
    flag = torch.where(ok, 0, 1).to(torch.int32)
    return out, flag


def _gather_crops(im: torch.Tensor, boxes) -> torch.Tensor:
    """Stack fixed-size crops (static start indices) into a (K, z, x, y)
    batch."""
    return torch.stack([im[b[0][0]:b[0][1], b[1][0]:b[1][1],
                           b[2][0]:b[2][1]] for b in boxes])


def align_image(src_im, ref_im, crops: Optional[np.ndarray] = None,
                drift_size: Optional[int] = None,
                upsample_factor: int = 100,
                normalization: Optional[str] = None,
                drift_diff_th: float = 1.0,
                min_good_drifts: int = 3,
                subtract_mean: bool = True,
                window: Optional[str] = "hann_xy",
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Crop-consensus drift of `src_im` against `ref_im` -> (drift, flag).

    Reference correction_tools/alignment.py:527-695 (align_image with
    use_autocorr=True): every crop registers at once (one batched
    :func:`subpixel_phase_correlation`), then :func:`consensus_drift`
    votes.  Crops are mean-subtracted and xy-Hann-windowed by default, as
    in the JAX package.  NumPy input goes to `device` (default the card).
    """
    src = as_tensor(src_im, device)
    ref = as_tensor(ref_im, src.device)
    if crops is None:
        crops = generate_drift_crops(tuple(src.shape), drift_size)
    boxes = [[[int(v) for v in ax] for ax in b] for b in crops]
    drifts = subpixel_phase_correlation(
        _gather_crops(ref.to(torch.float32), boxes),
        _gather_crops(src.to(torch.float32), boxes),
        upsample_factor=int(upsample_factor), normalization=normalization,
        subtract_mean=subtract_mean, window=window)
    return consensus_drift(drifts, drift_diff_th=drift_diff_th,
                           min_good_drifts=min_good_drifts)


def _corr2d_peak(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Signed integer peak (2,) of the phase correlation of two 2D views;
    the first maximum wins, as ``jnp.argmax`` picks it."""
    R = torch.fft.fftn(a) * torch.conj(torch.fft.fftn(b))
    R = R / R.abs().clamp_min(1e-20)
    cc = torch.fft.ifftn(R).abs()
    flat = int(cc.reshape(-1).argmax())
    n0, n1 = cc.shape
    pk = torch.tensor([flat // n1, flat % n1], dtype=torch.float32)
    size = torch.tensor([n0, n1], dtype=torch.float32)
    return torch.where(pk > size / 2, pk - size, pk)


def fft3d_from2d(src_im, ref_im, device=None) -> torch.Tensor:
    """Integer 3D drift (3,) from two 2D phase correlations of projections.

    Stage 1: max-project z -> (dx, dy); stage 2: roll src by that integer
    xy drift, max-project y (axis 2) -> dz.  Reference
    alignment_tools.py:330-353, with phase correlation in place of the
    blur-normalised fftconvolve, as the JAX package has it.
    """
    src = as_tensor(src_im, device).to(torch.float32)
    ref = as_tensor(ref_im, src.device).to(torch.float32)
    dxy = _corr2d_peak(ref.amax(dim=0), src.amax(dim=0))
    src_rolled = torch.roll(src, shifts=(int(dxy[0]), int(dxy[1])),
                            dims=(1, 2))
    dz = _corr2d_peak(ref.amax(dim=2), src_rolled.amax(dim=2))[0]
    return torch.stack([dz, dxy[0], dxy[1]]).to(src.device)
