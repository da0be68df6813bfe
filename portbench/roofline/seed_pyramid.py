"""``csrc/seed_pyramid.cu``: one launch classifies one corrected
(Z, X, Y) float32 channel against its 4x4-pooled background.

Bytes: the stack read and the qdiff map written (4 B a voxel each), the
pooled background read (4 B a pooled cell) and the level counts written.
Operations a voxel: three separable fg passes of `taps` products and
taps - 1 sums, 9 for the bilinear background, 26 maxima, the difference
and the compare (chip_smoke.py's count, without its 4 a qualifying voxel,
which the configuration does not fix)."""

from __future__ import annotations

import numpy as np

from ..harness.peaks import least_seconds
from ..reference.filters import gaussian_kernel1d


def least(config: dict, pk):
    nvox = float(np.prod(config["shape"]))
    s = config["pipeline"]["seed"]
    n_lvl = s["dynamic_niters"] if s["use_dynamic_th"] else 1
    taps = len(gaussian_kernel1d(s["gfilt_size"]))
    nbytes = 4 * nvox * 2 + 4 * nvox / 16 + 4 * n_lvl
    ops = nvox * (3 * (2 * taps - 1) + 9 + 26 + 2)
    return least_seconds(nbytes, ops, pk)
