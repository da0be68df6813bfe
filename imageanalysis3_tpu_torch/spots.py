"""Spot datatypes: the Spots3D array carrier, SpotTuple groups, and the
rendering of fitted spots back into an image.

The counterpart of ``imageanalysis3_tpu/spots.py``.  Behavior target:
reference classes/preprocess.py:13-316 -- `Spots3D` is an np.ndarray
subclass of (N, 11) natural rows carrying `bits`, `channels` and
`pixel_sizes`, with `to_coords` (px), `to_positions` (nm) and
`to_intensities`; `SpotTuple` wraps a decoded group with internal-distance
helpers.  Both are host NumPy containers, as in the JAX package;
``reconstruct_spot_image`` renders on the device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .config import DEFAULT_PIXEL_SIZE_NM
from .device import resolve_device

SPOT_COLUMNS = ["height", "z", "x", "y", "background", "sigma_z",
                "sigma_x", "sigma_y", "sin_t", "sin_p", "eps"]

#: elements of one chunk's (spots, window) scatter
_CHUNK_ELEMENTS = 1 << 24


class Spots3D(np.ndarray):
    """(N, 11) spot rows with bit/channel/pixel-size metadata."""

    def __new__(cls, spots, bits=None, channels=None,
                pixel_sizes=DEFAULT_PIXEL_SIZE_NM):
        obj = np.atleast_2d(np.asarray(spots, np.float64)).view(cls)
        n = len(obj)
        if bits is not None and np.isscalar(bits):
            bits = np.full(n, bits)
        obj.bits = None if bits is None else np.asarray(bits)
        if channels is not None and isinstance(channels, (str, int)):
            channels = [str(channels)] * n
        obj.channels = (None if channels is None
                        else np.asarray(channels).astype(str))
        obj.pixel_sizes = np.asarray(pixel_sizes, np.float64)
        return obj

    def __array_finalize__(self, obj):
        if obj is None:
            return
        self.bits = getattr(obj, "bits", None)
        self.channels = getattr(obj, "channels", None)
        self.pixel_sizes = getattr(obj, "pixel_sizes",
                                   np.asarray(DEFAULT_PIXEL_SIZE_NM))

    def to_coords(self) -> np.ndarray:
        """(N, 3) zxy in pixels."""
        return np.asarray(self)[:, 1:4]

    def to_positions(self, pixel_sizes=None) -> np.ndarray:
        """(N, 3) zxy in nm."""
        px = np.asarray(pixel_sizes if pixel_sizes is not None
                        else self.pixel_sizes)
        return self.to_coords() * px[None]

    def to_intensities(self) -> np.ndarray:
        return np.asarray(self)[:, 0]


class SpotTuple:
    """A decoded group of spots (reference classes/preprocess.py:139-316)."""

    def __init__(self, spots: Spots3D, bits=None, pixel_sizes=None,
                 spots_inds=None, tuple_id: Optional[int] = None):
        self.spots = spots if isinstance(spots, Spots3D) else \
            Spots3D(spots, bits=bits,
                    pixel_sizes=pixel_sizes or DEFAULT_PIXEL_SIZE_NM)
        self.bits = np.asarray(bits) if bits is not None else \
            self.spots.bits
        self.pixel_sizes = np.asarray(
            pixel_sizes if pixel_sizes is not None
            else self.spots.pixel_sizes)
        self.spots_inds = (None if spots_inds is None
                           else np.asarray(spots_inds))
        self.tuple_id = tuple_id

    def dist_internal(self) -> np.ndarray:
        """Pairwise distances (nm) among member spots, condensed order."""
        pos = self.spots.to_positions(self.pixel_sizes)
        n = len(pos)
        out = [np.linalg.norm(pos[i] - pos[j])
               for i in range(n) for j in range(i + 1, n)]
        return np.asarray(out)

    def intensities(self) -> np.ndarray:
        return self.spots.to_intensities()

    def centroid_spot(self) -> Spots3D:
        row = np.nanmean(np.asarray(self.spots), axis=0, keepdims=True)
        return Spots3D(row, pixel_sizes=self.pixel_sizes)


def _spot_windows(centers: torch.Tensor, heights: torch.Tensor,
                  stds: torch.Tensor, shape, radius: int):
    """Each spot's Gaussian on the (2r+1)^3 window around its rounded
    centre -> (flat voxel index (n, W) int64, value (n, W) float32, 0 where
    the voxel lies outside `shape`)."""
    dev = centers.device
    r = int(radius)
    g = torch.arange(-r, r + 1, device=dev)
    offs = torch.stack(torch.meshgrid(g, g, g, indexing="ij"),
                       dim=-1).reshape(-1, 3)
    base = torch.round(centers).to(torch.int32)
    vox = base[:, None, :] + offs[None]
    d = vox.to(torch.float32) - centers[:, None, :]
    q = d / stds[:, None, :]
    q = q * q
    val = heights[:, None] * torch.exp(-0.5 * (q[..., 0] + q[..., 1]
                                               + q[..., 2]))
    dims = torch.tensor(shape, dtype=torch.int32, device=dev)
    inb = ((vox >= 0) & (vox < dims)).all(dim=-1)
    cp = torch.minimum(vox.clamp_min(0), dims - 1).to(torch.int64)
    idx = (cp[..., 0] * shape[1] + cp[..., 1]) * shape[2] + cp[..., 2]
    return idx, torch.where(inb, val, 0.0)


def _spot_inputs(spots, use_intensity: bool, use_stds: bool,
                 given_stds, device):
    arr = spots if isinstance(spots, torch.Tensor) else torch.as_tensor(
        np.atleast_2d(np.asarray(spots, np.float64)), device=device)
    arr = torch.atleast_2d(arr).to(device)
    f32 = torch.float32
    centers = arr[:, 1:4].to(f32)
    heights = (arr[:, 0].to(f32) if use_intensity
               else torch.ones(arr.shape[0], dtype=f32, device=device))
    if use_stds:
        stds = arr[:, 5:8].double().clamp_min(1e-3).to(f32)
    else:
        stds = torch.as_tensor(np.maximum(np.asarray(given_stds, np.float64),
                                          1e-3).astype(np.float32),
                               device=device)[None].expand(arr.shape[0], 3)
    return centers, heights, stds


def reconstruct_spot_image(spots, image_size, use_intensity: bool = False,
                           use_stds: bool = True,
                           given_stds: Sequence[float] = (1.0, 1.0, 1.0),
                           radius: int = 8,
                           background: float = 0.0,
                           device=None) -> torch.Tensor:
    """Render fitted spots back into a 3D float32 image (decode/fit QC).

    Behavior target: visual_tools.py:3331-3348 (reconstruct_image over
    add_source:87-111) -- the sum of per-spot 3D Gaussians with the spot's
    own (sigma_z, sigma_x, sigma_y) or a shared ``given_stds``, unit height
    or the fitted intensity, each on the (2*radius+1)^3 window around its
    rounded centre.  One device pass: the windows are scatter-added with
    ``index_add_`` in chunks of spots (on the card in no fixed order, so
    sums of overlapping windows agree with a per-spot loop to rounding).
    `spots`: (N, 11) rows, a tensor (which keeps its device) or an array
    (which goes to `device`, default the card)."""
    dev = (spots.device if isinstance(spots, torch.Tensor)
           else resolve_device(device))
    shape = tuple(int(s) for s in image_size)
    flat = torch.zeros(int(np.prod(shape)), dtype=torch.float32, device=dev)
    centers, heights, stds = _spot_inputs(spots, use_intensity, use_stds,
                                          given_stds, dev)
    w = (2 * int(radius) + 1) ** 3
    chunk = max(1, _CHUNK_ELEMENTS // w)
    for s in range(0, centers.shape[0], chunk):
        idx, val = _spot_windows(centers[s:s + chunk],
                                 heights[s:s + chunk], stds[s:s + chunk],
                                 shape, radius)
        flat.index_add_(0, idx.reshape(-1), val.reshape(-1))
    return flat.reshape(shape) + background
