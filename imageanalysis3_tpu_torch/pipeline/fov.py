"""Per-FOV processing pipeline: correct -> register -> fit -> spot table.

The counterpart of ``imageanalysis3_tpu/pipeline/fov.py``.  Behavior
target: the reference's per-(dax, channels) worker
``batch_process_image_to_spots`` (classes/batch_functions.py:60-302)
driving ``correct_fov_image`` (io_tools/load.py:166-521) and
``fit_fov_image`` (spot_tools/fitting.py:169-262).

One hybridization round: corrections, 8-crop drift consensus against the
reference round, per-channel seeding + batched LM fitting, and chromatic +
drift correction of the fitted coordinates.  Everything runs eagerly on the
pipeline's device; the default device is the CUDA card, and a pipeline
without one raises unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import ExperimentConfig
from ..ops.corrections import correct_channel_stack
from ..ops.drift import (consensus_drift, generate_drift_crops,
                         prepare_ref_spectrum,
                         subpixel_phase_correlation_prepared)
from ..ops.gaussian_fit import iter_fit_seed_points
from ..ops.seeding import get_seeds
from ..ops.warp import warp_spot_coords


class RoundResult(NamedTuple):
    """Spot tables for one hybridization round of one FOV."""

    spots: torch.Tensor       # (C, N, 11) natural rows, drift+chrom corrected
    raw_spots: torch.Tensor   # (C, N, 11) as fitted (uncorrected coords)
    valid: torch.Tensor       # (C, N) bool
    drift: torch.Tensor       # (3,) zxy px
    drift_flag: torch.Tensor  # () int32: 0 consensus, 1 fallback


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA card when None; raises when CUDA is asked for
    (explicitly or by default) and no CUDA device exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "imageanalysis3_tpu_torch runs on a CUDA device and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def _crop(im, b):
    return im[b[0][0]:b[0][1], b[1][0]:b[1][1], b[2][0]:b[2][1]]


class FovPipeline:
    """Per-round FOV processor.

    Parameters
    ----------
    cfg : ExperimentConfig
    n_channels : number of data channels in the stack
    drift_channel_index : which channel drives registration
    fit_channel_indices : channels that are seeded and fit
    illumination / bleed / chromatic_constants : optional profile arrays
        ((C, X, Y), (C, C, X, Y), (C, 3, n_monomials)); None disables.
    device : torch device; None means the CUDA card
    """

    def __init__(self, cfg: ExperimentConfig, n_channels: int,
                 drift_channel_index: int,
                 fit_channel_indices: Tuple[int, ...],
                 illumination: Optional[np.ndarray] = None,
                 bleed: Optional[np.ndarray] = None,
                 chromatic_constants: Optional[np.ndarray] = None,
                 chromatic_ref_center: Optional[np.ndarray] = None,
                 image_shape: Optional[Tuple[int, int, int]] = None,
                 seed_thresholds: Optional[np.ndarray] = None,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_channels = int(n_channels)
        self.drift_idx = int(drift_channel_index)
        self.fit_idx = tuple(int(i) for i in fit_channel_indices)
        self.illumination = self._tensor(illumination)
        self.bleed = self._tensor(bleed)
        shape = tuple(int(s) for s in (image_shape or cfg.image_size))
        self.image_shape = shape
        self.crops = tuple(
            tuple(tuple(int(v) for v in ax) for ax in b)
            for b in generate_drift_crops(shape, cfg.drift.drift_size))
        if chromatic_constants is None:
            chromatic_constants = np.zeros((self.n_channels, 3, 10),
                                           np.float32)
        self.chromatic = self._tensor(chromatic_constants)
        if chromatic_ref_center is None:
            chromatic_ref_center = np.array(
                [shape[0] / 2, shape[1] / 2, shape[2] / 2], np.float32)
        self.chrom_center = self._tensor(chromatic_ref_center)
        if seed_thresholds is None:
            seed_thresholds = np.full(self.n_channels, cfg.seed.th_seed,
                                      np.float32)
        # on the host: each threshold parametrises a kernel launch
        self.seed_thresholds = np.array(seed_thresholds, np.float32)
        corr = cfg.correction
        # bleedthrough is the only stage that mixes channels; without it
        # each channel corrects on its own, so a round streams channels
        # (correct one, fit it, free it) instead of holding the whole
        # corrected (C, Z, X, Y) stack
        self.streaming = not (corr.bleedthrough and self.bleed is not None)

    def _tensor(self, a) -> Optional[torch.Tensor]:
        if a is None:
            return None
        return torch.as_tensor(np.array(a, np.float32), device=self.device)

    # -- stages -----------------------------------------------------------

    def _correct_kwargs(self):
        corr = self.cfg.correction
        return dict(
            hot_pixel=corr.hot_pixel, hot_pixel_th=corr.hot_pixel_th,
            hot_pixel_ratio=corr.hot_pixel_ratio, z_shift=corr.z_shift,
            do_illumination=(corr.illumination
                             and self.illumination is not None),
            do_highpass=corr.gaussian_highpass,
            highpass_sigma=corr.highpass_sigma,
            highpass_truncate=corr.highpass_truncate,
            median_subsample=corr.median_subsample,
            clip_min=corr.clip_min, clip_max=corr.clip_max)

    def correct(self, ims: torch.Tensor) -> torch.Tensor:
        """Correct a raw (C, Z, X, Y) stack (all channels)."""
        corr = self.cfg.correction
        return correct_channel_stack(
            ims, bleed_profile=self.bleed,
            illumination_profile=self.illumination,
            do_bleedthrough=corr.bleedthrough and self.bleed is not None,
            sequential_channels=self.n_channels > 1,
            **self._correct_kwargs())

    def correct_one(self, im: torch.Tensor, ci: int) -> torch.Tensor:
        """Correct channel `ci`'s raw (Z, X, Y) stack on its own (no
        cross-channel stage)."""
        illum = (self.illumination[ci][None]
                 if self.illumination is not None else None)
        return correct_channel_stack(
            im[None], illumination_profile=illum, do_bleedthrough=False,
            **self._correct_kwargs())[0]

    def ref_spectra(self, ref_im: torch.Tensor) -> torch.Tensor:
        """Per-crop conditioned rFFT spectra (K, z, x, y//2+1) of the
        corrected reference drift-channel image."""
        ref_b = torch.stack([_crop(ref_im, b) for b in self.crops])
        return prepare_ref_spectrum(ref_b,
                                    subtract_mean=self.cfg.drift.subtract_mean,
                                    window=self.cfg.drift.window)

    def drift_of(self, src_im: torch.Tensor, ref: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Consensus drift of a corrected drift-channel image against the
        reference (its corrected image, or its prepared spectra)."""
        dcfg = self.cfg.drift
        spectra = ref if ref.is_complex() else self.ref_spectra(ref)
        src_b = torch.stack([_crop(src_im, b) for b in self.crops])

        def drifts(sl):
            return subpixel_phase_correlation_prepared(
                spectra[sl], src_b[sl], upsample_factor=dcfg.upsample_factor,
                subtract_mean=dcfg.subtract_mean, window=dcfg.window)

        # two-phase consensus, the reference's early exit
        # (correction_tools/alignment.py:624-674): register the first
        # `phase1_crops` crops; only when they disagree spend FFTs on the
        # rest.  Reading the flag is one host synchronisation per round.
        k = len(self.crops)
        k1 = min(k, max(dcfg.min_good_drifts, dcfg.phase1_crops))
        drifts1 = drifts(slice(0, k1))
        out1, flag1 = consensus_drift(drifts1, drift_diff_th=dcfg.good_drift_th,
                                      min_good_drifts=dcfg.min_good_drifts)
        if k1 == k or int(flag1) == 0:
            return out1, flag1
        return consensus_drift(torch.cat([drifts1, drifts(slice(k1, k))]),
                               drift_diff_th=dcfg.good_drift_th,
                               min_good_drifts=dcfg.min_good_drifts)

    def fit_channel(self, im: torch.Tensor, th_seed: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Seed + fit one corrected channel -> (spots (N, 11), valid (N,))."""
        s, f = self.cfg.seed, self.cfg.fit
        seeds = get_seeds(
            im, max_num_seeds=s.max_num_seeds, th_seed=th_seed,
            gfilt_size=s.gfilt_size,
            background_gfilt_size=s.background_gfilt_size,
            filt_size=s.filt_size, min_edge_distance=s.min_edge_distance,
            use_dynamic_th=s.use_dynamic_th, dynamic_niters=s.dynamic_niters,
            min_dynamic_seeds=s.min_dynamic_seeds, pyramid_bg=s.pyramid_bg)
        res = iter_fit_seed_points(
            im, seeds.coords.to(torch.float32), seeds.valid,
            radius=f.radius, min_w=f.min_w, max_w=f.max_w, init_w=f.init_w,
            min_delta_center=f.min_delta_center,
            max_delta_center=f.max_delta_center, lm_iters=f.lm_iters,
            n_max_iter=f.n_max_iter, max_dist_th=f.max_dist_th,
            max_neighbors=f.max_neighbors)
        return res.spots, res.valid

    def _process_full(self, ims, ref) -> Tuple[RoundResult, torch.Tensor]:
        ims = torch.as_tensor(ims, device=self.device)
        ref = torch.as_tensor(ref, device=self.device)
        if self.streaming:
            corr_drift = self.correct_one(ims[self.drift_idx], self.drift_idx)
            channel_of = (lambda ci: corr_drift if ci == self.drift_idx
                          else self.correct_one(ims[ci], ci))
        else:
            corrected = self.correct(ims)
            corr_drift = corrected[self.drift_idx]
            channel_of = lambda ci: corrected[ci]
        drift, flag = self.drift_of(corr_drift, ref)
        raw, fixed, valid = [], [], []
        for ci in self.fit_idx:
            sp, va = self.fit_channel(channel_of(ci),
                                      float(self.seed_thresholds[ci]))
            raw.append(sp)
            valid.append(va)
            out = sp.clone()
            out[:, 1:4] = warp_spot_coords(sp[:, 1:4], self.chromatic[ci],
                                           self.chrom_center, drift)
            fixed.append(out)
        return RoundResult(spots=torch.stack(fixed), raw_spots=torch.stack(raw),
                           valid=torch.stack(valid), drift=drift,
                           drift_flag=flag), corr_drift

    # -- public API -------------------------------------------------------

    def correct_reference(self, ref_ims) -> torch.Tensor:
        """Correct the reference round and return its drift-channel image
        (reference Field_of_View._load_reference_image :734-801)."""
        ref_ims = torch.as_tensor(ref_ims, device=self.device)
        if self.streaming:
            return self.correct_one(ref_ims[self.drift_idx], self.drift_idx)
        return self.correct(ref_ims)[self.drift_idx]

    def prepare_reference(self, ref_im) -> torch.Tensor:
        """Per-crop drift spectra of the corrected reference image; compute
        once per FOV and pass to `process_round` in place of the image."""
        return self.ref_spectra(torch.as_tensor(ref_im, device=self.device))

    def process_round(self, ims, ref_im) -> RoundResult:
        """Process one round's raw (C, Z, X, Y) stack against the reference
        (the corrected image or its `prepare_reference` spectra)."""
        return self._process_full(ims, ref_im)[0]

    def process_round_returning_ref(self, ims, ref_im
                                    ) -> Tuple[RoundResult, torch.Tensor]:
        """`process_round` that also returns the corrected drift-channel
        stack, for sequential drift mode where each round is the next
        round's registration target."""
        return self._process_full(ims, ref_im)
