"""The plain reference of one hybridization round.

What ``FovPipeline.process_round`` owes, written out from the frozen plain
copies beside this file: each channel corrected on its own (hot pixels,
z-shift, flat field, clip), the drift channel registered against the
reference round's prepared crop spectra with the two-phase consensus, each
data channel seeded and fitted, and the fitted coordinates moved by the
chromatic polynomial and the drift.  It reads only the raw stack, the
profiles the benchmark made and the configuration, never anything the
program made.  ``cfg`` is the configuration file's ``pipeline`` section.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from .corrections import correct_channel_stack, deinterleave_stack
from .drift import (consensus_drift, generate_drift_crops,
                    prepare_ref_spectrum, subpixel_phase_correlation_prepared)
from .gaussian_fit import iter_fit_seed_points
from .seeding import get_seeds
from .warp import warp_spot_coords


class RoundOut(NamedTuple):
    spots: torch.Tensor     # (F, N, 11) corrected coordinates
    valid: torch.Tensor     # (F, N) bool
    drift: torch.Tensor     # (3,)
    flag: int


def _crop(im, b):
    return im[b[0][0]:b[0][1], b[1][0]:b[1][1], b[2][0]:b[2][1]]


class ReferenceRound:
    """One round of the plain reference for a fixed layout: `illumination`
    (C, X, Y) or None, `chromatic` (C, 3, 10), each channel's seeding
    threshold `seed_th` (C,), the data channels `fit_idx` and the drift
    channel `drift_idx`."""

    def __init__(self, cfg: dict, shape: Sequence[int], drift_idx: int,
                 fit_idx: Sequence[int], illumination, chromatic,
                 seed_th: Sequence[float], device):
        self.cfg = cfg
        self.shape = tuple(int(s) for s in shape)
        self.drift_idx = int(drift_idx)
        self.fit_idx = tuple(int(i) for i in fit_idx)
        self.seed_th = tuple(float(t) for t in seed_th)
        self.device = torch.device(device)
        self.illumination = (None if illumination is None else
                             torch.as_tensor(illumination, dtype=torch.float32,
                                             device=self.device))
        self.chromatic = torch.as_tensor(chromatic, dtype=torch.float32,
                                         device=self.device)
        self.center = torch.tensor([s / 2 for s in self.shape],
                                   dtype=torch.float32, device=self.device)
        self.crops = tuple(
            tuple(tuple(int(v) for v in ax) for ax in b)
            for b in generate_drift_crops(self.shape,
                                          cfg["drift"]["drift_size"]))

    def correct(self, im: torch.Tensor, ci: int) -> torch.Tensor:
        c = self.cfg["correction"]
        illum = (self.illumination[ci][None]
                 if self.illumination is not None and c["illumination"]
                 else None)
        return correct_channel_stack(
            im[None], illumination_profile=illum, do_bleedthrough=False,
            hot_pixel=c["hot_pixel"], hot_pixel_th=c["hot_pixel_th"],
            hot_pixel_ratio=c["hot_pixel_ratio"], z_shift=c["z_shift"],
            do_illumination=illum is not None,
            do_highpass=c["gaussian_highpass"],
            highpass_sigma=c["highpass_sigma"],
            highpass_truncate=c["highpass_truncate"],
            median_subsample=c["median_subsample"], clip_min=c["clip_min"],
            clip_max=c["clip_max"])[0]

    def spectra(self, ref_raw: torch.Tensor) -> torch.Tensor:
        """Prepared crop spectra of the reference round's drift channel."""
        d = self.cfg["drift"]
        im = self.correct(ref_raw[self.drift_idx].to(self.device),
                          self.drift_idx)
        return prepare_ref_spectrum(
            torch.stack([_crop(im, b) for b in self.crops]),
            subtract_mean=d["subtract_mean"], window=d["window"])

    def drift(self, im: torch.Tensor, spectra: torch.Tensor
              ) -> Tuple[torch.Tensor, int]:
        d = self.cfg["drift"]
        src = torch.stack([_crop(im, b) for b in self.crops])

        def drifts(sl):
            return subpixel_phase_correlation_prepared(
                spectra[sl], src[sl], upsample_factor=d["upsample_factor"],
                subtract_mean=d["subtract_mean"], window=d["window"])

        k = len(self.crops)
        k1 = min(k, max(d["min_good_drifts"], d["phase1_crops"]))
        first = drifts(slice(0, k1))
        out, flag = consensus_drift(first, drift_diff_th=d["good_drift_th"],
                                    min_good_drifts=d["min_good_drifts"])
        if k1 < k and int(flag) != 0:
            out, flag = consensus_drift(
                torch.cat([first, drifts(slice(k1, k))]),
                drift_diff_th=d["good_drift_th"],
                min_good_drifts=d["min_good_drifts"])
        return out, int(flag)

    def fit(self, im: torch.Tensor, th_seed: float):
        s, f = self.cfg["seed"], self.cfg["fit"]
        seeds = get_seeds(
            im, max_num_seeds=s["max_num_seeds"], th_seed=th_seed,
            gfilt_size=s["gfilt_size"],
            background_gfilt_size=s["background_gfilt_size"],
            filt_size=s["filt_size"], min_edge_distance=s["min_edge_distance"],
            use_dynamic_th=s["use_dynamic_th"],
            dynamic_niters=s["dynamic_niters"],
            min_dynamic_seeds=s["min_dynamic_seeds"],
            cand_capacity=s["cand_capacity"], pyramid_bg=s["pyramid_bg"])
        res = iter_fit_seed_points(
            im, seeds.coords.to(torch.float32), seeds.valid,
            radius=f["radius"], min_w=f["min_w"], max_w=f["max_w"],
            init_w=f["init_w"], min_delta_center=f["min_delta_center"],
            max_delta_center=f["max_delta_center"], lm_iters=f["lm_iters"],
            n_max_iter=f["n_max_iter"], max_dist_th=f["max_dist_th"],
            max_neighbors=f["max_neighbors"])
        return res.spots, res.valid

    def run(self, raw: torch.Tensor, spectra: torch.Tensor) -> RoundOut:
        """One raw (C, Z, X, Y) round against the prepared spectra."""
        raw = raw.to(self.device)
        drift, flag = self.drift(self.correct(raw[self.drift_idx],
                                              self.drift_idx), spectra)
        spots, valid = [], []
        for ci in self.fit_idx:
            sp, va = self.fit(self.correct(raw[ci], ci), self.seed_th[ci])
            out = sp.clone()
            out[:, 1:4] = warp_spot_coords(sp[:, 1:4], self.chromatic[ci],
                                           self.center, drift)
            spots.append(out)
            valid.append(va)
        return RoundOut(torch.stack(spots), torch.stack(valid), drift, flag)

    def run_raw_window(self, window: torch.Tensor, spectra: torch.Tensor,
                       rel_starts: Sequence[int], n_colors: int) -> RoundOut:
        """One round from its raw interleaved frame window."""
        raw = deinterleave_stack(window.to(self.device),
                                 tuple(int(s) for s in rel_starts),
                                 int(n_colors), self.shape[0])
        return self.run(raw, spectra)
