"""Correction-profile files: the reference's on-disk naming conventions.

A copy of ``imageanalysis3_tpu/io/profiles_io.py`` (the port imports nothing
of the JAX package).  Behavior target: io_tools/load.py:553-640
(load_correction_profile) -- a correction folder holds profiles addressed
purely by naming convention:

  * illumination        `illumination_correction_{ch}_{X}x{Y}.npy`
  * bleedthrough        `bleedthrough_correction_{chs desc}_{X}_{Y}.npy`
    (channels joined high-to-low; stored flattened (C*C, X, Y))
  * chromatic           `chromatic_correction_{ch}_{ref}_{Z}_{X}_{Y}.npy`
  * chromatic_constants `chromatic_correction_{ch}_{ref}_{Z}_{X}_{Y}_const.pkl`

The names, layouts and pickle payload (the (3, n_monomials) array
``ops.warp`` consumes) are the JAX package's, so a folder written by either
package loads in the other.  Profiles may be NumPy arrays or tensors; they
are written as NumPy arrays and read back as NumPy arrays.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Sequence

import numpy as np

from ..config import CHROMATIC_REF_CHANNEL, CORR_CHANNELS, DEFAULT_IMAGE_SIZE

_ALLOWED_TYPES = ("chromatic", "illumination", "bleedthrough",
                  "chromatic_constants")


def _numpy(value) -> np.ndarray:
    """A profile as a NumPy array (tensors leave their device)."""
    if hasattr(value, "detach"):
        value = value.detach().cpu().numpy()
    return np.asarray(value)


def _bleed_basename(corr_channels, im_size) -> str:
    chs = "_".join(sorted([str(c) for c in corr_channels],
                          key=lambda v: -int(v)))
    return (f"bleedthrough_correction_{chs}"
            f"_{im_size[-2]}_{im_size[-1]}.npy")


def _illumination_basename(channel, im_size) -> str:
    return (f"illumination_correction_{channel}"
            f"_{im_size[-2]}x{im_size[-1]}.npy")


def _chromatic_basename(channel, ref_channel, im_size,
                        constants: bool) -> str:
    base = f"chromatic_correction_{channel}_{ref_channel}"
    for d in im_size:
        base += f"_{int(d)}"
    return base + ("_const.pkl" if constants else ".npy")


def load_correction_profile(corr_type: str,
                            correction_folder: str,
                            corr_channels: Sequence[str] = CORR_CHANNELS,
                            ref_channel: str = CHROMATIC_REF_CHANNEL,
                            im_size: Sequence[int] = DEFAULT_IMAGE_SIZE):
    """Load a profile set by the reference naming convention.

    Returns: bleedthrough -> (C, C, X, Y) array; illumination /
    chromatic / chromatic_constants -> {channel: array-or-None} with the
    reference's None for the chromatic reference channel.
    """
    t = str(corr_type).lower()
    if t not in _ALLOWED_TYPES:
        raise ValueError(f"corr_type must be one of {_ALLOWED_TYPES}")
    chs = [str(c) for c in corr_channels]
    if t == "bleedthrough":
        path = os.path.join(correction_folder,
                            _bleed_basename(chs, im_size))
        pf = np.load(path, allow_pickle=True)
        return pf.reshape(len(chs), len(chs), im_size[-2], im_size[-1])
    out: Dict[str, Optional[np.ndarray]] = {}
    for ch in chs:
        if t == "illumination":
            path = os.path.join(correction_folder,
                                _illumination_basename(ch, im_size))
            out[ch] = np.load(path, allow_pickle=True)
        elif ch == str(ref_channel):
            out[ch] = None
        elif t == "chromatic":
            path = os.path.join(
                correction_folder,
                _chromatic_basename(ch, ref_channel, im_size, False))
            out[ch] = np.load(path, allow_pickle=True)
        else:
            path = os.path.join(
                correction_folder,
                _chromatic_basename(ch, ref_channel, im_size, True))
            with open(path, "rb") as fh:
                out[ch] = pickle.load(fh)
    return out


def save_correction_profile(corr_type: str, profile,
                            correction_folder: str,
                            corr_channels: Sequence[str] = CORR_CHANNELS,
                            ref_channel: str = CHROMATIC_REF_CHANNEL,
                            im_size: Sequence[int] = DEFAULT_IMAGE_SIZE
                            ) -> None:
    """Persist profiles under the reference naming convention (the write
    side the reference's Generate_* functions implement ad hoc)."""
    t = str(corr_type).lower()
    if t not in _ALLOWED_TYPES:
        raise ValueError(f"corr_type must be one of {_ALLOWED_TYPES}")
    os.makedirs(correction_folder, exist_ok=True)
    chs = [str(c) for c in corr_channels]
    if t == "bleedthrough":
        arr = _numpy(profile)
        flat = arr.reshape(len(chs) * len(chs), im_size[-2], im_size[-1])
        np.save(os.path.join(
            correction_folder,
            _bleed_basename(chs, im_size)).removesuffix(".npy"), flat)
        return
    for ch, value in profile.items():
        if value is None:
            continue
        if t == "illumination":
            path = os.path.join(correction_folder,
                                _illumination_basename(ch, im_size))
            np.save(path.removesuffix(".npy"), _numpy(value))
        elif t == "chromatic":
            path = os.path.join(
                correction_folder,
                _chromatic_basename(ch, ref_channel, im_size, False))
            np.save(path.removesuffix(".npy"), _numpy(value))
        else:
            path = os.path.join(
                correction_folder,
                _chromatic_basename(ch, ref_channel, im_size, True))
            with open(path, "wb") as fh:
                pickle.dump(_numpy(value), fh)
