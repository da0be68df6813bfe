"""Stateful per-.dax processing facade with a correction ledger.

The counterpart of ``imageanalysis3_tpu/pipeline/dax_processer.py``.
Behavior target: reference classes/preprocess.py:337-1256 (DaxProcesser):
a per-movie object exposing stepwise corrections -- `_load_image`,
`_corr_bleedthrough`, `_corr_hot_pixels_3D`, `_corr_Z_shift`,
`_corr_illumination`, `_calculate_drift`, `_warp_image`,
`_gaussian_highpass`, `_fit_spots`, `_fit_spots_by_segmentation` -- with a
per-channel `correction_log` ledger so re-running a step is a no-op (:387,
:482-487, :557-566), plus the static helpers `_FindDaxChannels` /
`_FindImageSize` / `_LoadInfFile`.

Where the JAX facade pulls every step's result back to the host, this one
keeps ``ims`` as float32 tensors on its device between steps (the CUDA card
unless ``device="cpu"``); ``drift`` is a (3,) tensor there too.  Users
wanting the fused path use ``FovPipeline`` instead.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ALLOWED_COLORS
from ..device import resolve_device
from ..io.dax import read_inf
from ..io.native_loader import load_dax_channels
from ..io.profiles_io import load_correction_profile
from ..ops.corrections import (bleedthrough_unmix, illumination_correct,
                               remove_hot_pixels, z_shift_correct)
from ..ops.cell_fitting import fit_spots_by_segmentation
from ..ops.drift import align_image
from ..ops.filters import gaussian_highpass
from ..ops.gaussian_fit import FitResult, fit_fov_image
from ..ops.warp import warp_image, warp_spot_coords


class DaxProcesser:
    """Stepwise corrections on one .dax movie (reference DaxProcesser)."""

    def __init__(self, filename: str,
                 correction_channels: Optional[Sequence[str]] = None,
                 all_channels: Optional[Sequence[str]] = None,
                 single_im_size: Optional[Sequence[int]] = None,
                 num_buffer_frames: int = 10,
                 num_empty_frames: int = 0,
                 verbose: bool = False,
                 device=None):
        self.filename = filename
        self.verbose = verbose
        self.device = resolve_device(device)
        self.num_buffer_frames = num_buffer_frames
        self.num_empty_frames = num_empty_frames
        self.all_channels = list(all_channels) if all_channels else \
            self._FindDaxChannels(filename, single_im_size,
                                  num_buffer_frames, num_empty_frames)
        self.channels = (list(correction_channels)
                         if correction_channels else list(self.all_channels))
        self.single_im_size = (tuple(single_im_size) if single_im_size
                               else self._FindImageSize(
                                   filename, len(self.all_channels),
                                   num_buffer_frames, num_empty_frames))
        self.ims: Dict[str, torch.Tensor] = {}
        #: per-channel step ledger (reference correction_log semantics)
        self.correction_log: Dict[str, Dict[str, bool]] = {
            ch: {} for ch in self.channels}
        self.drift: Optional[torch.Tensor] = None
        self.drift_flag: Optional[int] = None

    # -- static metadata helpers (reference :1150-1256) -------------------

    @staticmethod
    def _LoadInfFile(filename: str):
        return read_inf(filename)

    @staticmethod
    def _FindImageSize(filename: str, n_channels: int,
                       num_buffer_frames: int = 10,
                       num_empty_frames: int = 0) -> Tuple[int, int, int]:
        meta = read_inf(filename)
        usable = (meta.number_frames - 2 * num_buffer_frames
                  - num_empty_frames)
        return (usable // max(n_channels, 1), *meta.frame_shape)

    @staticmethod
    def _FindDaxChannels(filename: str,
                         single_im_size=None,
                         num_buffer_frames: int = 10,
                         num_empty_frames: int = 0) -> List[str]:
        """Infer the channel list from frame accounting: the usable frame
        count must decompose into n_channels stacks of equal depth."""
        meta = read_inf(filename)
        usable = (meta.number_frames - 2 * num_buffer_frames
                  - num_empty_frames)
        if single_im_size is not None:
            n = usable // int(single_im_size[0])
            return list(ALLOWED_COLORS[:n])
        for n in range(len(ALLOWED_COLORS), 0, -1):
            if usable % n == 0:
                return list(ALLOWED_COLORS[:n])
        return [ALLOWED_COLORS[0]]

    # -- steps -------------------------------------------------------------

    def _mark(self, step: str, channels=None):
        for ch in (channels or self.channels):
            self.correction_log[ch][step] = True

    def _done(self, step: str, channels=None) -> bool:
        return all(self.correction_log[ch].get(step, False)
                   for ch in (channels or self.channels))

    def _load_image(self) -> "DaxProcesser":
        """Read the movie's selected channels (the native fused loader: the
        values of read_dax + split_channels) and move them to the device
        as uint16, where they become float32."""
        if self.ims:
            return self
        block = load_dax_channels(self.filename, self.channels,
                                  self.all_channels,
                                  n_z=self.single_im_size[0],
                                  buffer_frames=self.num_buffer_frames,
                                  empty_frames=self.num_empty_frames)
        up = torch.as_tensor(block, device=self.device)
        self.ims = {ch: up[i].to(torch.float32)
                    for i, ch in enumerate(self.channels)}
        self._mark("load")
        return self

    def _corr_hot_pixels_3D(self, hot_pixel_th: float = 0.5,
                            hot_th: float = 4.0) -> "DaxProcesser":
        if self._done("hot_pixel"):
            return self
        for ch in self.channels:
            self.ims[ch] = remove_hot_pixels(
                self.ims[ch], hot_pix_th=hot_pixel_th, hot_th=hot_th)
        self._mark("hot_pixel")
        return self

    def _corr_Z_shift(self) -> "DaxProcesser":
        if self._done("z_shift"):
            return self
        for ch in self.channels:
            self.ims[ch] = z_shift_correct(self.ims[ch])
        self._mark("z_shift")
        return self

    def _profile(self, profile) -> torch.Tensor:
        return torch.as_tensor(profile, dtype=torch.float32,
                               device=self.device)

    def _corr_illumination(self, profiles: Dict[str, np.ndarray]
                           ) -> "DaxProcesser":
        for ch in self.channels:
            if self.correction_log[ch].get("illumination") or \
                    ch not in profiles:
                continue
            self.ims[ch] = illumination_correct(
                self.ims[ch], self._profile(profiles[ch])).clamp(0, 65535)
            self.correction_log[ch]["illumination"] = True
        return self

    def _corr_bleedthrough(self, profile: np.ndarray,
                           channels: Optional[Sequence[str]] = None
                           ) -> "DaxProcesser":
        chs = list(channels or self.channels)
        if all(self.correction_log[c].get("bleedthrough") for c in chs):
            return self
        out = bleedthrough_unmix(torch.stack([self.ims[c] for c in chs]),
                                 self._profile(profile))
        for i, c in enumerate(chs):
            self.ims[c] = out[i].clamp(0, 65535)
            self.correction_log[c]["bleedthrough"] = True
        return self

    def _gaussian_highpass(self, sigma: float = 3.0,
                           truncate: float = 2.0) -> "DaxProcesser":
        if self._done("highpass"):
            return self
        for ch in self.channels:
            self.ims[ch] = gaussian_highpass(self.ims[ch], sigma, truncate)
        self._mark("highpass")
        return self

    def _calculate_drift(self, ref_im, drift_channel: Optional[str] = None,
                         **align_kwargs) -> torch.Tensor:
        ch = drift_channel or self.channels[-1]
        ref = torch.as_tensor(ref_im, device=self.device)
        drift, flag = align_image(self.ims[ch], ref, **align_kwargs)
        self.drift = drift
        self.drift_flag = int(flag)
        return self.drift

    def _drift_or_zero(self) -> torch.Tensor:
        if self.drift is not None:
            return self.drift
        return torch.zeros(3, dtype=torch.float32, device=self.device)

    def _center(self) -> torch.Tensor:
        return torch.tensor([s / 2 for s in self.single_im_size],
                            dtype=torch.float32, device=self.device)

    def _warp_image(self, channels: Optional[Sequence[str]] = None,
                    chromatic_constants: Optional[Dict[str, np.ndarray]]
                    = None) -> "DaxProcesser":
        drift = self._drift_or_zero()
        for ch in (channels or self.channels):
            if self.correction_log[ch].get("warp"):
                continue
            consts = (chromatic_constants or {}).get(ch)
            self.ims[ch] = warp_image(
                self.ims[ch], drift,
                None if consts is None else self._profile(consts),
                None if consts is None else self._center())
            self.correction_log[ch]["warp"] = True
        return self

    def _fit_spots(self, channels: Optional[Sequence[str]] = None,
                   **fit_kwargs) -> Dict[str, FitResult]:
        out = {}
        for ch in (channels or self.channels):
            out[ch] = fit_fov_image(self.ims[ch], **fit_kwargs)
        self.spots = out
        return out

    def _fit_spots_by_segmentation(self, channel: str, seg_label,
                                   th_seed: float = 500.0,
                                   num_spots: Optional[int] = None,
                                   segment_search_radius: int = 3,
                                   **fit_kwargs
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fit spots per segmented cell (reference
        DaxProcesser._fit_spots_by_segmentation,
        classes/preprocess.py:1093-1152), the cells' boxes moved by
        ``drift``.  Returns (spots, cell_ids) tensors on the processer's
        device and stores them as `spots_<ch>` / `spots_cell_ids_<ch>`."""
        spots, cell_ids = fit_spots_by_segmentation(
            self.ims[channel], torch.as_tensor(seg_label,
                                               device=self.device),
            th_seed=th_seed, num_spots=num_spots,
            segment_search_radius=segment_search_radius,
            drift=self.drift, **fit_kwargs)
        setattr(self, f"spots_{channel}", spots)
        setattr(self, f"spots_cell_ids_{channel}", cell_ids)
        return spots, cell_ids

    def _correct_spot_coords(self, spots_zxy, channel: str,
                             chromatic_constants: Optional[Dict[str,
                                                                np.ndarray]]
                             = None) -> torch.Tensor:
        """Chromatic+drift correction applied to coordinates (the modern
        warp_image=False path)."""
        consts = (chromatic_constants or {}).get(channel)
        if consts is None:
            consts = np.zeros((3, 10), np.float32)
        return warp_spot_coords(
            torch.as_tensor(spots_zxy, dtype=torch.float32,
                            device=self.device),
            self._profile(consts), self._center(), self._drift_or_zero())


def batch_process_image_quick(dax_filename: str,
                              correction_folder: Optional[str],
                              sel_channels: Sequence[str],
                              corr_hot_pixels: bool = True,
                              corr_illumination: bool = True,
                              verbose: bool = False,
                              **dax_kwargs) -> Dict[str, torch.Tensor]:
    """Quick DaxProcesser application (reference
    batch_process_image_quick, classes/preprocess.py:1257+): load the
    selected channels, apply hot-pixel and illumination corrections,
    return the per-channel stacks (float32 tensors on the processer's
    device).  Illumination profiles load from `correction_folder` by the
    reference naming convention and are skipped (with a note when verbose)
    if absent.  Extra kwargs (all_channels, single_im_size,
    num_buffer_frames, device, ...) pass through to DaxProcesser."""
    proc = DaxProcesser(dax_filename, correction_channels=sel_channels,
                        verbose=verbose, **dax_kwargs)
    proc._load_image()
    if corr_hot_pixels:
        proc._corr_hot_pixels_3D()
    if corr_illumination and correction_folder:
        profiles: Dict[str, np.ndarray] = {}
        for ch in sel_channels:
            try:
                profiles.update(load_correction_profile(
                    "illumination", correction_folder,
                    corr_channels=[ch], im_size=proc.single_im_size))
            except FileNotFoundError:
                if verbose:
                    print(f"-- skip illumination for {ch} (no profile)")
        proc._corr_illumination(profiles)
    return proc.ims
