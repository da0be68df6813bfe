"""Spot partitioning: assign spots to segmented cells, count genes.

The counterpart of ``imageanalysis3_tpu/analysis/partition.py``.  Behavior
targets (reference ImageAnalysis3):
  * label lookup per spot       classes/partition_spots.py:113-140
    (Spots_Partition.spots_to_labels: gather the segmentation labels in a
    cube around each spot, take the most frequent positive label, -1 if
    none)
  * DAPI signal per spot        classes/partition_spots.py:142-155
  * coordinate intensities      classes/partition_spots.py:212-236
  * gene count matrix           classes/partition_spots.py:52-110
  * mask translation            segmentation_tools/cell.py:548-597

Every lookup is one tensor gather of the (2r+1)^3 cube around each rounded
spot, chunked over spots so that a FOV's spots fit in memory (at r = 10 a
spot reads 9261 voxels).  The label vote sorts each spot's cube and counts
runs with ``searchsorted``; the first maximum of the counts is the smallest
of the tied labels, as in the JAX package.  Rounding is half to even
(``torch.round``, as ``jnp.round``).  NumPy inputs go to `device` (default
the CUDA card); tensors stay where they are.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import as_tensor, host_array

#: elements of one chunk's (spots, cube) gather
_CHUNK_ELEMENTS = 1 << 25


def _cube_offsets(radius: int) -> np.ndarray:
    g = np.indices([2 * radius + 1] * 3).reshape(3, -1).T - radius
    return g.astype(np.int32)


def _cube_gather(im: torch.Tensor, coords: torch.Tensor, radius: int,
                 reduce, out_dtype) -> torch.Tensor:
    """reduce(values (n, P), in-bounds (n, P)) over each chunk of spots,
    where values are `im` at the clamped cube voxels around the rounded
    coordinates."""
    dev = im.device
    offs = torch.as_tensor(_cube_offsets(radius), device=dev).to(
        torch.int64)
    shape = torch.tensor(im.shape, dtype=torch.int64, device=dev)
    flat = im.reshape(-1)
    n = coords.shape[0]
    chunk = max(1, _CHUNK_ELEMENTS // offs.shape[0])
    out = []
    for s in range(0, n, chunk):
        base = torch.round(coords[s:s + chunk].to(torch.float32)).to(
            torch.int32).to(torch.int64)
        pos = base[:, None, :] + offs[None]
        inb = ((pos >= 0) & (pos < shape)).all(dim=-1)
        cpos = torch.minimum(torch.clamp_min(pos, 0), shape - 1)
        idx = (cpos[..., 0] * im.shape[1] + cpos[..., 1]) * im.shape[2] \
            + cpos[..., 2]
        out.append(reduce(flat[idx], inb))
    if not out:
        return torch.zeros(0, dtype=out_dtype, device=dev)
    return torch.cat(out)


def _mode_positive(vals: torch.Tensor, inb: torch.Tensor) -> torch.Tensor:
    """Most frequent positive value of each row, the smallest on a tie,
    -1 where a row holds none."""
    vals = torch.where(inb, vals.to(torch.int32), 0)
    s = torch.sort(vals, dim=1).values.contiguous()
    left = torch.searchsorted(s, s, right=False)
    right = torch.searchsorted(s, s, right=True)
    cnt = torch.where(s > 0, right - left, 0)
    best = torch.argmax(cnt, dim=1, keepdim=True)
    lab = s.gather(1, best)[:, 0]
    return torch.where(cnt.gather(1, best)[:, 0] > 0, lab, -1)


def spots_to_labels(label_im, coords, valid, search_radius: int = 10,
                    device=None) -> torch.Tensor:
    """Most-frequent positive segmentation label around each spot.

    label_im: (Z, X, Y) int; coords: (N, 3) zxy px; valid: (N,) bool.
    Returns (N,) int32 cell labels, -1 where no positive label is found or
    the spot is invalid."""
    lab = as_tensor(label_im, device)
    dev = lab.device
    coords = as_tensor(coords, dev).to(dev)
    valid = as_tensor(valid, dev).to(device=dev, dtype=torch.bool)
    got = _cube_gather(lab, coords, search_radius, _mode_positive,
                       torch.int32)
    return torch.where(valid, got, -1).to(torch.int32)


def spots_to_intensity(im, coords, valid, search_radius: int = 5,
                       device=None) -> torch.Tensor:
    """Max image intensity in a cube around each spot (reference
    spots_to_DAPI); NaN for invalid spots."""
    imt = as_tensor(im, device)
    dev = imt.device
    coords = as_tensor(coords, dev).to(dev)
    valid = as_tensor(valid, dev).to(device=dev, dtype=torch.bool)

    def cube_max(vals, inb):
        vals = torch.where(inb, vals.to(torch.float32), float("-inf"))
        return vals.amax(dim=1)

    got = _cube_gather(imt, coords, search_radius, cube_max, torch.float32)
    return torch.where(valid, got, float("nan"))


def find_coordinate_intensities(im, coords, search_radius: int = 5,
                                device=None) -> torch.Tensor:
    """(N, (2r+1)^3) image intensities around each rounded spot
    coordinate, edge-CLAMPED rather than masked: out-of-bounds voxels read
    the nearest border voxel (reference find_coordinate_intensities)."""
    imt = as_tensor(im, device)
    coords = as_tensor(coords, imt.device).to(imt.device)
    return _cube_gather(imt, coords, search_radius,
                        lambda vals, inb: vals.to(torch.float32),
                        torch.float32).reshape(
        -1, (2 * search_radius + 1) ** 3)


def count_genes(labels_per_bit: Dict[int, np.ndarray],
                n_cells: Optional[int] = None) -> Tuple[np.ndarray,
                                                        np.ndarray,
                                                        np.ndarray]:
    """Per-(cell, bit) spot counts -> (counts (C, B), cell ids, bit ids):
    rows are the cells present in any bit's labels, columns the bits in
    sorted order (host NumPy; tensors are read back first)."""
    bits = sorted(labels_per_bit)
    labs = {b: host_array(labels_per_bit[b]).ravel() for b in bits}
    all_labels = (np.concatenate([labs[b] for b in bits]) if bits
                  else np.zeros(0))
    cells = np.unique(all_labels[all_labels > 0]).astype(np.int32)
    counts = np.zeros((len(cells), len(bits)), np.int32)
    for j, b in enumerate(bits):
        lab = labs[b][labs[b] > 0]
        if len(lab):
            np.add.at(counts[:, j], np.searchsorted(cells, lab), 1)
    return counts, cells, np.asarray(bits, np.int32)


def _rigid_plane_map(shape: Tuple[int, int, int], rotation_xy,
                     drift, device):
    """Shared inverse rigid map of the nearest-neighbour warps: output
    voxel o samples source s = R^-1 @ (o_xy - c) + c - drift_xy per xy
    plane, z layers shift by -drift_z (nearest layer).  Returns (per-plane
    flat gather index, in-bounds mask, source z layer ids)."""
    z, x, y = shape
    f32 = torch.float32
    rot = as_tensor(rotation_xy, device).to(device=device, dtype=f32)
    drift = as_tensor(drift, device).to(device=device, dtype=f32)
    cx = (x - 1) / 2.0
    cy = (y - 1) / 2.0
    xs = torch.arange(x, dtype=f32, device=device)[:, None] - cx
    ys = torch.arange(y, dtype=f32, device=device)[None, :] - cy
    rinv = torch.linalg.inv(rot)
    sx = rinv[0, 0] * xs + rinv[0, 1] * ys + cx - drift[1]
    sy = rinv[1, 0] * xs + rinv[1, 1] * ys + cy - drift[2]
    xi = torch.round(sx).to(torch.int32).to(torch.int64).clamp(0, x - 1)
    yi = torch.round(sy).to(torch.int32).to(torch.int64).clamp(0, y - 1)
    inb = (sx >= -0.5) & (sx <= x - 0.5) & (sy >= -0.5) & (sy <= y - 0.5)
    zi = torch.round(torch.arange(z, dtype=f32, device=device) - drift[0]
                     ).to(torch.int32).to(torch.int64).clamp(0, z - 1)
    return xi * y + yi, inb, zi


def _warp_planes(vol: torch.Tensor, rotation_xy, drift) -> torch.Tensor:
    plane_idx, inb, zi = _rigid_plane_map(tuple(vol.shape), rotation_xy,
                                          drift, vol.device)
    out = vol[zi].reshape(vol.shape[0], -1)[:, plane_idx.reshape(-1)]
    out = out.reshape(vol.shape)
    return torch.where(inb[None], out, torch.zeros((), dtype=vol.dtype,
                                                   device=vol.device))


def translate_label_image(labels, rotation_xy, drift,
                          device=None) -> torch.Tensor:
    """Rigid rotation (about the xy image centre) + drift of a label
    volume, nearest-neighbour resampled (reference translate_segmentation,
    cv2.warpAffine semantics); out-of-bounds voxels become background 0.
    Returns int32."""
    lab = as_tensor(labels, device)
    return _warp_planes(lab.to(torch.int32), rotation_xy, drift)


def translate_volume(im, rotation_xy, drift, device=None) -> torch.Tensor:
    """Float32 variant of :func:`translate_label_image` (same inverse rigid
    map, nearest neighbour): warps e.g. a DAPI stack into another
    experiment's frame; out-of-bounds voxels become 0."""
    imt = as_tensor(im, device)
    return _warp_planes(imt.to(torch.float32), rotation_xy, drift)
