"""Microscope-geometry parameters (microscope.json): transpose/flip
corrections for images and spot tables.

The port's own copy of ``imageanalysis3_tpu/io/microscope.py``; its image
correction takes NumPy arrays or tensors.  Behavior targets: reference
io_tools/parameters.py:5-8 (_read_microscope_json),
segmentation_tools/cell.py:437-463 (_correct_image3D/2D_by_microscope_param),
and spot_tools/translating.py:95-117 (MicroscopeTranslate_Spots).  These
reconcile data acquired on microscopes whose cameras are transposed or
mirrored relative to each other (e.g. RNA vs DNA scopes) before
segmentation masks or spots can be shared across experiments.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np
import torch


def read_microscope_json(path: str) -> Dict:
    """microscope.json -> parameter dict (keys used here: `transpose`,
    `flip_horizontal`, `flip_vertical`)."""
    with open(path, "r") as fh:
        return json.load(fh)


def load_position_file(path: str) -> np.ndarray:
    """Stage-position file (comma-delimited `x,y` per line, the
    acquisition software's positions.txt) -> (N, 2) float array
    (reference meta_tools/global_alignments.py:4-9 Load_PositionFile;
    the reference returns a two-column DataFrame — downstream consumers
    index columns x/y positionally, which the array preserves)."""
    out = np.loadtxt(path, delimiter=",", dtype=np.float64, ndmin=2)
    if out.shape[1] != 2:
        raise ValueError(f"position file {path} has {out.shape[1]} "
                         "columns, expected x,y")
    return out


def microscope_correct_image(image, params: Dict):
    """Apply transpose / horizontal / vertical flips to a (Z, X, Y) or
    (X, Y) image (reference _correct_image3D/2D_by_microscope_param).
    Works on NumPy arrays (transpose/flip views) or tensors
    (``permute`` / ``torch.flip``, on the tensor's device)."""
    if not isinstance(params, dict):
        raise TypeError("microscope params must be a dict")
    im = image
    if im.ndim not in (2, 3):
        raise ValueError(f"image must be 2d or 3d, got {im.ndim}d")
    xy = (im.ndim - 2, im.ndim - 1)
    tensor = isinstance(im, torch.Tensor)
    if params.get("transpose"):
        order = tuple(range(im.ndim - 2)) + (xy[1], xy[0])
        im = im.permute(order) if tensor else im.transpose(order)
    for key, axis in (("flip_horizontal", xy[1]), ("flip_vertical", xy[0])):
        if params.get(key):
            im = torch.flip(im, (axis,)) if tensor else np.flip(im, axis)
    return im


def microscope_translate_spots(spots: np.ndarray, params: Dict,
                               image_size) -> np.ndarray:
    """Apply the microscope geometry to (N, 11) spot rows' coordinates
    (reference MicroscopeTranslate_Spots, spot_tools/translating.py:
    95-117: transpose swaps x<->y, flips mirror about the image center;
    only coordinates change — widths/orientation columns pass through,
    as in the reference)."""
    out = np.array(spots, copy=True)
    size = np.asarray(image_size)
    if params.get("transpose"):
        out[:, [2, 3]] = out[:, [3, 2]]
    if params.get("flip_horizontal"):
        out[:, 3] = -(out[:, 3] - size[2] / 2) + size[2] / 2
    if params.get("flip_vertical"):
        out[:, 2] = -(out[:, 2] - size[1] / 2) + size[1] / 2
    return out
