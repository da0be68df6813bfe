"""Typed configuration tree of the PyTorch/CUDA FISH pipeline.

A copy of ``imageanalysis3_tpu/config.py`` (the constants and the five
dataclasses), kept here so the port never imports the JAX package.  The
reference scatters its configuration over module globals, a
``shared_parameters`` dict and per-call kwargs; here everything is a frozen
dataclass tree, one hashable, serializable object per experiment.
:func:`config_from_dict` rebuilds it from ``dataclasses.asdict`` output, so
a JAX-side configuration carries across unchanged.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Global defaults (reference: __init__.py:17-40)
# ---------------------------------------------------------------------------

#: nm per voxel along (z, x, y)   (reference `_distance_zxy`)
DEFAULT_PIXEL_SIZE_NM: Tuple[float, float, float] = (200.0, 108.0, 108.0)

#: default Gaussian sigma prior along (z, x, y) in px (reference `_sigma_zxy`)
DEFAULT_SIGMA_ZXY: Tuple[float, float, float] = (1.35, 1.9, 1.9)

#: default per-channel z-stack shape (z, x, y) (reference `_image_size`)
DEFAULT_IMAGE_SIZE: Tuple[int, int, int] = (30, 2048, 2048)

#: recognized laser lines, in frame-interleave order (reference `_allowed_colors`)
ALLOWED_COLORS: Tuple[str, ...] = ("750", "647", "561", "488", "405")

#: channels participating in bleedthrough/chromatic correction
#: (reference `_corr_channels`)
CORR_CHANNELS: Tuple[str, ...] = ("750", "647", "561")

#: chromatic reference channel (reference `_ref_channel`)
CHROMATIC_REF_CHANNEL: str = "647"

#: per-channel default seeding thresholds
#: (reference `classes/batch_functions.py:10-17` Channel_2_SeedTh)
CHANNEL_SEED_THRESHOLDS = {
    "750": 400.0,
    "647": 600.0,
    "561": 600.0,
    "488": 600.0,
    "405": 600.0,
}


# ---------------------------------------------------------------------------
# Config dataclasses
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CorrectionConfig:
    """Which corrections the fused pass applies, and their parameters.

    Mirrors the toggles in the reference ``shared_parameters``
    (``classes/field_of_view.py:200-280``: corr_bleed / corr_Z_shift /
    corr_hot_pixel / corr_illumination / corr_chromatic /
    corr_gaussian_highpass) and kernel params from ``corrections.py`` /
    ``correction_tools/filter.py``.
    """

    hot_pixel: bool = True
    hot_pixel_th: float = 0.5        # fraction of z-layers (hot_pix_th)
    hot_pixel_ratio: float = 4.0     # intensity ratio over 4-neighbor mean (hot_th)
    z_shift: bool = True
    bleedthrough: bool = False
    illumination: bool = True
    chromatic: bool = True
    gaussian_highpass: bool = False
    highpass_sigma: float = 3.0
    highpass_truncate: float = 2.0
    # output clipping range (uint16 semantics, reference io_tools/load.py:363-366)
    clip_min: float = 0.0
    clip_max: float = 65535.0
    # z-shift median from every s-th full x-row.  The binary search is
    # the correction stage's dominant device-memory traffic, and a 260k+
    # sample's median sits within ~1 quarter-code (<0.1% normalization
    # shift) of the exact one.  1 = exact (raw-op default).
    median_subsample: int = 16


@dataclass(frozen=True)
class DriftConfig:
    """Crop-consensus drift correction (reference correction_tools/alignment.py:527-695)."""

    drift_channel: str = "488"
    drift_size: int = 512            # crop edge (reference: max(im_size)/4)
    n_crops: int = 8                 # generate_drift_crops -> 8 crops
    use_autocorr: bool = True        # phase correlation (vs bead matching)
    upsample_factor: int = 100       # 0.01 px subpixel precision (precision_fold)
    good_drift_th: float = 1.0       # crops agreeing within 1 px form consensus
    min_good_drifts: int = 3
    # crops registered in the first consensus phase; the remaining crops
    # are touched only when these disagree.  The reference's sequential
    # loop (correction_tools/alignment.py:624-674) exits as soon as the
    # first `min_good_drifts` crops agree, so phase1 = min_good_drifts is
    # the reference's own common path (and ~25% less FFT work than the
    # previous k/2).  Raise toward n_crops//2 for noisy experiments where
    # one bad crop among the first three would otherwise force phase 2.
    phase1_crops: int = 3
    # crop conditioning before the FFT: mean subtraction kills the constant
    # background's overlap-triangle bias, the xy Hann window suppresses
    # crop-boundary leakage (the role blurnorm2d plays in the reference,
    # alignment_tools.py:278-328)
    subtract_mean: bool = True
    window: Optional[str] = "hann_xy"


@dataclass(frozen=True)
class SeedConfig:
    """Local-maximum seeding (reference spot_tools/fitting.py:20-154 get_seeds)."""

    th_seed: float = 300.0
    gfilt_size: float = 0.75
    background_gfilt_size: float = 7.5
    filt_size: int = 3
    min_edge_distance: int = 2
    use_dynamic_th: bool = True
    dynamic_niters: int = 10
    min_dynamic_seeds: int = 1
    max_num_seeds: int = 1024        # fixed capacity of the device seed table
    # unused since the hierarchical top-k seed extraction (get_seeds does
    # not take it); kept so a JAX-side config carries across unchanged
    cand_capacity: int = 16384
    # pyramid background: the bg Gaussian runs on a 4x4-pooled grid and is
    # bilinearly upsampled inside the classifier (ops/seed_kernels.py
    # fused_seed_classify_pyramid).  Identical seed sets to the exact
    # classifier on planted-spot stacks; the plateau guard moves to
    # pooled-cell resolution.  The config picks the algorithm on every
    # device: the CUDA kernel on a CUDA tensor, its plain version on a CPU
    # tensor.
    pyramid_bg: bool = True


@dataclass(frozen=True)
class FitConfig:
    """Constrained 3D Gaussian LM fit (reference External/Fitting_v4.py:165-683)."""

    radius: int = 5                  # radius_fit: ball of pixels per spot
    min_w: float = 0.5
    max_w: float = 4.0
    init_w: float = 1.5
    min_delta_center: float = 1.0    # firstfit center box half-width
    max_delta_center: float = 2.5    # repeatfit center box half-width
    max_dist_th: float = 0.1         # convergence: center moved < 0.1 px
    # repeatfit rounds / inner LM iterations, the JAX package's defaults:
    # on the bench scene (1800 spots, 60x2048x2048) accuracy is flat from
    # lm_iters=20 down to 8, because the moment-based center init
    # (init_params' centroid start) moves the LM start within ~0.1 px of
    # the optimum.  n_max_iter=6 keeps repeatfit margin for crowded fields.
    n_max_iter: int = 6
    lm_iters: int = 8
    max_neighbors: int = 12          # capacity of interacting-spot lists


@dataclass(frozen=True)
class ExperimentConfig:
    """Top-level experiment configuration."""

    image_size: Tuple[int, int, int] = DEFAULT_IMAGE_SIZE
    pixel_size_nm: Tuple[float, float, float] = DEFAULT_PIXEL_SIZE_NM
    all_channels: Tuple[str, ...] = ALLOWED_COLORS
    corr_channels: Tuple[str, ...] = CORR_CHANNELS
    chromatic_ref_channel: str = CHROMATIC_REF_CHANNEL
    num_buffer_frames: int = 10
    num_empty_frames: int = 0
    correction: CorrectionConfig = field(default_factory=CorrectionConfig)
    drift: DriftConfig = field(default_factory=DriftConfig)
    seed: SeedConfig = field(default_factory=SeedConfig)
    fit: FitConfig = field(default_factory=FitConfig)

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


_SECTIONS = {"correction": CorrectionConfig, "drift": DriftConfig,
             "seed": SeedConfig, "fit": FitConfig}


def config_from_dict(d: dict) -> ExperimentConfig:
    """Rebuild an :class:`ExperimentConfig` from its ``dataclasses.asdict``
    form (lists back to tuples, nested sections back to dataclasses)."""
    kw = {}
    for name, value in d.items():
        if name in _SECTIONS:
            value = _SECTIONS[name](**{
                k: tuple(v) if isinstance(v, list) else v
                for k, v in value.items()})
        elif isinstance(value, list):
            value = tuple(value)
        kw[name] = value
    return ExperimentConfig(**kw)
