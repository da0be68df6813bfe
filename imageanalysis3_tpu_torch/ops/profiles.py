"""Correction-profile generation: illumination, bleedthrough, chromatic.

The counterpart of ``imageanalysis3_tpu/ops/profiles.py``.  Behavior targets
(reference ImageAnalysis3):
  * illumination profiles      correction_tools/illumination.py:16-206
    (per FOV clip to [5, 90] percentiles, sum over z, gaussian(60); mean over
    FOVs, gaussian(60) again, normalize by max)
  * bleedthrough profiles      correction_tools/bleedthrough.py:56-520
    (fit ref-channel spots, per-spot linear regression of the target crop on
    the reference crop, keep r^2 >= 0.81; an order-2 polynomial slope field;
    per-pixel inverse of the channel-mixing matrix)
  * chromatic constants        correction_tools/chromatic.py:119+ /
    corrections.py:885-1008 (bead fits in two channels -> paired centres
    -> per-dimension polynomial shift lstsq)

The percentile clip is a counting quantile (no 250 M-element sort), the
per-spot regressions are one closed-form (cov/var) pass over gathered pixel
blocks (``gather_blocks``, the gather kernel's ball entry), the polynomial
field fit is a normalised SVD least squares, and the per-pixel mixing
inverse is one batched ``torch.linalg.inv`` over (X*Y, C, C).  The entry
points put NumPy inputs on `device` (default the card) and leave tensors
where they are; the illumination running sum stays on the device.
Profiles come back as NumPy arrays, the form the profile files hold.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import as_tensor, resolve_device
from .filters import gaussian_filter
from .gaussian_fit import (fit_fov_image, gather_blocks, get_centers,
                           select_sparse_centers)
from .matching import find_paired_centers
from .warp import fit_chromatic_constants, normalized_lstsq, polynomial_basis


# ---------------------------------------------------------------------------
# Quantiles (counting-based, no huge sorts)
# ---------------------------------------------------------------------------


def _quantile_rank(q: float, n: int) -> int:
    """max(1, ceil(q * n)) as the JAX package computes it: the Python
    product rounded to f32 (a weak-typed scalar under JAX_ENABLE_X64=0),
    then ceil.  At n = 251,658,240 the f32 spacing is 16, so a float64 rank
    could land on another rank."""
    return max(1, int(np.ceil(np.float32(q * n))))


def _counting_quantiles(imf: torch.Tensor, qs: Sequence[float],
                        bits: int = 18) -> torch.Tensor:
    """Quantiles `qs` of `imf` by one shared binary search over the
    fixed-point codes floor(4x + 0.5) (int32, one copy of the stack) ->
    (len(qs),) f32."""
    n = imf.numel()
    dev = imf.device
    codes = torch.floor(imf * 4.0 + 0.5).to(torch.int32)
    rank = torch.tensor([_quantile_rank(q, n) for q in qs],
                        dtype=torch.int64, device=dev)
    lo = torch.zeros(len(qs), dtype=torch.int32, device=dev)
    hi = torch.full((len(qs),), (1 << bits) - 1, dtype=torch.int32,
                    device=dev)
    for _ in range(bits):
        mid = (lo + hi) >> 1
        cnt = torch.stack([(codes <= mid[i]).sum() for i in range(len(qs))])
        ok = cnt >= rank
        lo, hi = torch.where(ok, lo, mid + 1), torch.where(ok, mid, hi)
    return lo.to(torch.float32) / 4.0


def counting_quantile(im, q: float, bits: int = 18) -> torch.Tensor:
    """Quantile via binary search over a fixed-point value domain (the
    generalization of filters.counting_median to arbitrary q), exact on a
    1/4-integer grid within [0, 2^16)."""
    imf = as_tensor(im).to(torch.float32)
    return _counting_quantiles(imf, (q,), bits)[0]


# ---------------------------------------------------------------------------
# Illumination flat-field generation
# ---------------------------------------------------------------------------


def _stack_to_illumination(im: torch.Tensor, cap_lo: float = 0.05,
                           cap_hi: float = 0.90,
                           smooth_sigma: float = 60.0) -> torch.Tensor:
    """One stack's illumination contribution (reference _image_to_profile,
    correction_tools/illumination.py:145-195): percentile clip, z-sum, 2D
    gaussian(smooth_sigma)."""
    imf = im.to(torch.float32)
    lo, hi = _counting_quantiles(imf, (cap_lo, cap_hi))
    flat = imf.clamp(torch.minimum(lo, hi), torch.maximum(lo, hi)).sum(dim=0)
    return gaussian_filter(flat, smooth_sigma)


class IlluminationProfiler:
    """Streaming flat-field estimator: feed per-FOV stacks, finalize once.

    Mirrors Generate_illumination_correction
    (correction_tools/illumination.py:16-145): mean of per-FOV smoothed
    z-sums, smoothed again and normalized to peak 1.  The running sum lives
    on `device` (default the card); each stack is moved there on its own.
    """

    def __init__(self, shape_xy: Tuple[int, int],
                 cap_th_per: Tuple[float, float] = (5.0, 90.0),
                 smooth_sigma: float = 60.0, device=None):
        self.device = resolve_device(device)
        self.shape_xy = tuple(int(s) for s in shape_xy)
        self.cap = (cap_th_per[0] / 100.0, cap_th_per[1] / 100.0)
        self.smooth_sigma = float(smooth_sigma)
        self._sum = torch.zeros(self.shape_xy, dtype=torch.float32,
                                device=self.device)
        self._n = 0

    def add_stack(self, im) -> None:
        im = torch.as_tensor(im, device=self.device)
        self._sum += _stack_to_illumination(im, self.cap[0], self.cap[1],
                                            self.smooth_sigma)
        self._n += 1

    def finalize(self) -> np.ndarray:
        if self._n == 0:
            raise ValueError("no stacks accumulated")
        prof = gaussian_filter(self._sum / self._n, self.smooth_sigma)
        return (prof / prof.max()).cpu().numpy()


# ---------------------------------------------------------------------------
# Bleedthrough generation
# ---------------------------------------------------------------------------


class PairRegression(NamedTuple):
    slopes: torch.Tensor      # (N,)
    intercepts: torch.Tensor  # (N,)
    rsq: torch.Tensor         # (N,)
    valid: torch.Tensor       # (N,)


def fit_spot_pair_regressions(ref_im: torch.Tensor, tar_im: torch.Tensor,
                              centers: torch.Tensor, valid: torch.Tensor,
                              crop_radius: int = 4) -> PairRegression:
    """Per-spot linear regression of the target crop on the reference crop
    (reference find_bleedthrough_pairs, correction_tools/bleedthrough.py:
    110-140): crop both channels around each reference spot, regress
    tar = slope * ref + intercept, report r^2.  Closed form (cov/var),
    batched over spots."""
    ref_px, _, mask = gather_blocks(ref_im, centers, crop_radius)
    tar_px, _, _ = gather_blocks(tar_im, centers, crop_radius)
    m = mask.to(torch.float32)
    n = m.sum(dim=1).clamp_min(1.0)
    mx = (ref_px * m).sum(dim=1) / n
    my = (tar_px * m).sum(dim=1) / n
    dx = (ref_px - mx[:, None]) * m
    dy = (tar_px - my[:, None]) * m
    sxx = (dx * dx).sum(dim=1)
    sxy = (dx * dy).sum(dim=1)
    syy = (dy * dy).sum(dim=1)
    slope = sxy / sxx.clamp_min(1e-12)
    return PairRegression(slopes=slope, intercepts=my - slope * mx,
                          rsq=(sxy * sxy) / (sxx * syy).clamp_min(1e-12),
                          valid=valid & (sxx > 0))


def polynomial_field_2d(coords_xy: torch.Tensor, values: torch.Tensor,
                        weights: torch.Tensor, shape_xy: Tuple[int, int],
                        order: int = 2,
                        ref_center: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Weighted polynomial fit of scattered values -> dense (X, Y) field
    (reference interploate_bleedthrough_correction_from_channel,
    correction_tools/bleedthrough.py:300-336).

    Rows of weight 0 contribute exact zeros, so a dropped row whose centre
    or value is not finite (a failed fit) cannot reach the solve; the JAX
    package's 0 * NaN would carry it in."""
    dev = coords_xy.device
    if ref_center is None:
        ref_center = torch.tensor([shape_xy[0] / 2.0, shape_xy[1] / 2.0],
                                  dtype=torch.float32, device=dev)
    w = weights.to(torch.float32)
    use = w != 0
    x = polynomial_basis(coords_xy - ref_center[None], order)
    xw = torch.where(use[:, None], x * w[:, None], 0.0)
    coef = normalized_lstsq(xw, torch.where(use, values * w, 0.0))
    xx, yy = torch.meshgrid(
        torch.arange(shape_xy[0], dtype=torch.float32, device=dev),
        torch.arange(shape_xy[1], dtype=torch.float32, device=dev),
        indexing="ij")
    grid = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1) \
        - ref_center[None]
    # a weighted column sum, not a matmul: no TF32 whatever the caller set
    field = (polynomial_basis(grid, order) * coef).sum(dim=-1)
    return field.reshape(shape_xy)


def invert_mixing_profile(mixing) -> torch.Tensor:
    """Per-pixel inverse of a (C, C, X, Y) channel-mixing field
    (reference Generate_bleedthrough_correction inverse loop,
    correction_tools/bleedthrough.py:477-487) as one batched inverse."""
    mixing = as_tensor(mixing).to(torch.float32)
    c, _, x, y = mixing.shape
    m = mixing.reshape(c, c, -1).permute(2, 0, 1)            # (XY, C, C)
    return torch.linalg.inv(m).permute(1, 2, 0).reshape(c, c, x, y)


def _bleed_profile(ref_and_targets, c: int, shape_xy, device, th_seeds,
                   crop_radius, rsq_th, max_num_seeds, fitting_order,
                   min_spots) -> np.ndarray:
    """The bleedthrough workflow over C (ref image, {tar: image}) sources:
    per ordered channel pair fit ref spots, regress the target crops, keep
    r^2 >= rsq_th, fit the slope field into mixing[tar, ref]; diagonal 1;
    invert per pixel."""
    if th_seeds is None:
        th_seeds = [300.0] * c
    mixing = torch.zeros((c, c) + tuple(shape_xy), dtype=torch.float32,
                         device=device)
    for i in range(c):
        mixing[i, i] = 1.0
    for ref_i in range(c):
        ref_im, tar_ims = ref_and_targets(ref_i)
        ref_im = ref_im.to(torch.float32)
        res = fit_fov_image(ref_im, max_num_seeds=max_num_seeds,
                            th_seed=th_seeds[ref_i])
        centers = res.spots[:, 1:4]
        for tar_i, tar_im in tar_ims.items():
            reg = fit_spot_pair_regressions(
                ref_im, tar_im.to(torch.float32), centers, res.valid,
                crop_radius)
            keep = reg.valid & (reg.rsq >= rsq_th)
            if int(keep.sum()) < min_spots:
                continue
            # mixing[tar, ref]: how much of ref leaks into tar
            mixing[tar_i, ref_i] = polynomial_field_2d(
                centers[:, 1:3], reg.slopes, keep.to(torch.float32),
                shape_xy, order=fitting_order)
    return invert_mixing_profile(mixing).cpu().numpy()


def generate_bleed_profile(ims: Sequence, th_seeds: Sequence[float] = None,
                           crop_radius: int = 4, rsq_th: float = 0.81,
                           max_num_seeds: int = 256, fitting_order: int = 2,
                           min_spots: int = 8, device=None) -> np.ndarray:
    """Full bleedthrough workflow on one multi-channel stack (`ims[c]` is
    channel c's (Z, X, Y)) -> inverse unmixing profile (C, C, X, Y)
    consumable by :func:`ops.corrections.bleedthrough_unmix`.

    Mirrors Generate_bleedthrough_correction
    (correction_tools/bleedthrough.py:353-520).
    """
    ims = [as_tensor(im, device) for im in ims]
    c = len(ims)

    def sources(ref_i):
        return ims[ref_i], {t: ims[t] for t in range(c) if t != ref_i}

    return _bleed_profile(sources, c, tuple(ims[0].shape[1:]), ims[0].device,
                          th_seeds, crop_radius, rsq_th, max_num_seeds,
                          fitting_order, min_spots)


def generate_bleed_profile_from_rounds(stacks: Sequence,
                                       th_seeds: Sequence[float] = None,
                                       crop_radius: int = 4,
                                       rsq_th: float = 0.81,
                                       max_num_seeds: int = 256,
                                       fitting_order: int = 2,
                                       min_spots: int = 8,
                                       device=None) -> np.ndarray:
    """Bleedthrough profile from per-channel calibration rounds.

    ``stacks[i]`` is one full (C, Z, X, Y) multi-channel stack from a round
    where ONLY channel i is labelled -- the reference's calibration input
    (one ``bleed_folder`` per channel, correction_tools/bleedthrough.py:
    353-430).  Spots are fit in the labelled channel of each round; every
    other channel's crops are regressed against them, so leak directions
    never contaminate each other.  Returns the inverse unmixing profile
    (C, C, X, Y).
    """
    stacks = [as_tensor(s, device) for s in stacks]
    c = len(stacks)
    if not all(s.shape[0] == c for s in stacks):
        raise ValueError("each calibration stack must carry all C channels")

    def sources(ref_i):
        ims = stacks[ref_i]
        return ims[ref_i], {t: ims[t] for t in range(c) if t != ref_i}

    return _bleed_profile(sources, c, tuple(stacks[0].shape[2:]),
                          stacks[0].device, th_seeds, crop_radius, rsq_th,
                          max_num_seeds, fitting_order, min_spots)


# ---------------------------------------------------------------------------
# Chromatic constants generation
# ---------------------------------------------------------------------------


def generate_chromatic_constants(tar_im, ref_im, th_seed: float = 300.0,
                                 max_num_seeds: int = 512,
                                 match_cutoff: float = 3.0,
                                 sparse_th: float = 15.0,
                                 max_order: int = 2,
                                 ref_center: Optional[np.ndarray] = None,
                                 device=None) -> Tuple[np.ndarray, int]:
    """Chromatic-shift polynomial from one bead stack imaged in two
    channels -> ((3, n_monomials) constants, n_pairs used).

    Mirrors Generate_chromatic_abbrevation (correction_tools/chromatic.py:
    119+ / corrections.py:885-1008): fit bead centres in both channels,
    keep isolated reference beads, pair within `match_cutoff`, lstsq the
    per-dimension shift polynomial (ops.warp.fit_chromatic_constants).
    The constants feed warp_spot_coords directly.
    """
    tar_im = as_tensor(tar_im, device)
    ref_im = as_tensor(ref_im, device)
    dev = tar_im.device
    if ref_center is None:
        ref_center = np.asarray(tar_im.shape, np.float32) / 2.0
    tar_cts, tar_ok = get_centers(tar_im, th_seed=th_seed,
                                  max_num_seeds=max_num_seeds)
    ref_cts, ref_ok = get_centers(ref_im, th_seed=th_seed,
                                  max_num_seeds=max_num_seeds)
    ref_ok = ref_ok & select_sparse_centers(ref_cts, ref_ok, sparse_th)
    pairs = find_paired_centers(tar_cts, tar_ok, ref_cts, ref_ok,
                                cutoff=match_cutoff)
    # only the valid pairs enter the (normalised) solve
    constants = fit_chromatic_constants(
        pairs.tar[pairs.mask], pairs.ref[pairs.mask],
        torch.as_tensor(np.asarray(ref_center, np.float32), device=dev),
        max_order=max_order)
    return constants.cpu().numpy(), int(pairs.n_pairs)
