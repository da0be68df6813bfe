"""Carry a pipeline's state across from its NumPy form.

The main path has no learned weights; its state is the per-FOV arrays a
``FovPipeline`` holds (illumination and bleed profiles, chromatic constants
and centre, per-channel seed thresholds, drift crop boxes) plus the
prepared reference spectra.  :func:`pipeline_from_arrays` rebuilds a port
pipeline from those arrays as NumPy (e.g. ``np.asarray`` of the JAX
package's pipeline attributes) and a ``dataclasses.asdict`` config, so the
two packages compute the same thing.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .config import config_from_dict
from .pipeline.fov import FovPipeline

#: structural keys (small integer arrays) and the optional state arrays
STRUCTURE_KEYS = ("image_shape", "drift_idx", "fit_idx")
STATE_KEYS = ("illumination", "bleed", "chromatic", "chrom_center",
              "seed_thresholds", "crops", "ref_spectra")


def pipeline_from_arrays(cfg_dict: dict, arrays: Dict[str, np.ndarray],
                         device=None
                         ) -> Tuple[FovPipeline, Optional[torch.Tensor]]:
    """Build a port ``FovPipeline`` (and its prepared reference) from
    NumPy arrays.

    `arrays` holds ``image_shape`` (3,), ``drift_idx`` (), ``fit_idx`` (F,),
    ``chromatic`` (C, 3, M), ``chrom_center`` (3,), ``seed_thresholds``
    (C,), ``crops`` (K, 3, 2), and optionally ``illumination`` (C, X, Y),
    ``bleed`` (C, C, X, Y) and ``ref_spectra`` (K, z, x, y//2+1) complex.
    Returns (pipeline, reference spectra on the device or None).
    """
    unknown = set(arrays) - set(STRUCTURE_KEYS) - set(STATE_KEYS)
    if unknown:
        raise KeyError(f"pipeline_from_arrays: unknown arrays {sorted(unknown)}")
    cfg = config_from_dict(cfg_dict)
    th = np.asarray(arrays["seed_thresholds"], np.float32)
    pipe = FovPipeline(
        cfg, n_channels=th.shape[0],
        drift_channel_index=int(arrays["drift_idx"]),
        fit_channel_indices=tuple(int(i) for i in
                                  np.atleast_1d(arrays["fit_idx"])),
        illumination=arrays.get("illumination"),
        bleed=arrays.get("bleed"),
        chromatic_constants=arrays["chromatic"],
        chromatic_ref_center=arrays["chrom_center"],
        image_shape=tuple(int(s) for s in arrays["image_shape"]),
        seed_thresholds=th, device=device)
    crops = np.asarray(arrays["crops"]).astype(int)
    pipe.crops = tuple(tuple(tuple(int(v) for v in ax) for ax in b)
                       for b in crops)
    spectra = arrays.get("ref_spectra")
    if spectra is not None:
        spectra = torch.as_tensor(np.array(spectra, np.complex64),
                                  device=pipe.device)
    return pipe, spectra
