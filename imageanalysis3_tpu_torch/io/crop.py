"""Crop primitives: interval boxes with overlap, drift translation.

The port's own copy of ``imageanalysis3_tpu/io/crop.py`` (NumPy boxes).

Behavior target: reference classes/preprocess.py:17-137 (ImageCrop /
ImageCrop_3d) and io_tools/crop.py:59-151 (generate_neighboring_crop):
axis-aligned integer crop boxes that clamp to the image, slice arrays,
test/compute overlaps, and translate under a drift.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclass
class ImageCrop3D:
    """(3, 2) integer interval box clamped to `image_size`."""

    array: np.ndarray                     # (3, 2) [lo, hi) per axis
    image_size: Optional[Tuple[int, int, int]] = None

    def __post_init__(self):
        arr = np.asarray(self.array, np.int64).reshape(3, 2).copy()
        if self.image_size is not None:
            size = np.asarray(self.image_size, np.int64)
            arr[:, 0] = np.clip(arr[:, 0], 0, size)
            arr[:, 1] = np.clip(arr[:, 1], 0, size)
        self.array = arr

    @classmethod
    def from_center(cls, center: Sequence[float], crop_size,
                    image_size: Optional[Sequence[int]] = None
                    ) -> "ImageCrop3D":
        """Box of edge `crop_size` around `center` (reference
        generate_neighboring_crop, io_tools/crop.py:59-151)."""
        center = np.asarray(center, float)
        if np.isscalar(crop_size):
            crop_size = [crop_size] * 3
        half = np.asarray(crop_size, float) / 2.0
        lo = np.floor(center - half).astype(np.int64)
        hi = np.ceil(center + half).astype(np.int64)
        return cls(np.stack([lo, hi], axis=1),
                   None if image_size is None else tuple(image_size))

    def to_slices(self) -> Tuple[slice, slice, slice]:
        return tuple(slice(int(lo), int(hi)) for lo, hi in self.array)

    def crop(self, im: np.ndarray) -> np.ndarray:
        return im[self.to_slices()]

    @property
    def shape(self) -> Tuple[int, int, int]:
        return tuple(int(hi - lo) for lo, hi in self.array)

    def overlap(self, other: "ImageCrop3D") -> Optional["ImageCrop3D"]:
        """Intersection box, or None when disjoint (reference
        ImageCrop.overlap semantics)."""
        lo = np.maximum(self.array[:, 0], other.array[:, 0])
        hi = np.minimum(self.array[:, 1], other.array[:, 1])
        if np.any(hi <= lo):
            return None
        return ImageCrop3D(np.stack([lo, hi], axis=1), self.image_size)

    def translate_drift(self, drift: Sequence[float]) -> "ImageCrop3D":
        """Box shifted by (rounded) drift, re-clamped (reference
        ImageCrop_3d.translate_drift)."""
        d = np.round(np.asarray(drift, float)).astype(np.int64)
        return ImageCrop3D(self.array + d[:, None], self.image_size)

    def relative_coords(self, coords: np.ndarray) -> np.ndarray:
        """Global zxy -> coordinates within this crop."""
        return np.asarray(coords, float) - self.array[:, 0][None]

    def contains(self, coords: np.ndarray) -> np.ndarray:
        c = np.atleast_2d(np.asarray(coords, float))
        return np.all((c >= self.array[:, 0][None])
                      & (c < self.array[:, 1][None]), axis=1)


def generate_neighboring_crop(center, crop_size, single_im_size
                              ) -> ImageCrop3D:
    """Reference io_tools/crop.py:59-151 signature front door."""
    return ImageCrop3D.from_center(center, crop_size,
                                   image_size=tuple(single_im_size))
