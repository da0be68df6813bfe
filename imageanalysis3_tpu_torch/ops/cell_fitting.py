"""Per-cell / per-chromosome crop fitting: seed + fit inside local crops.

The counterpart of ``imageanalysis3_tpu/ops/cell_fitting.py``.  Behavior
targets (reference ImageAnalysis3):
  * fit-by-segmentation        classes/preprocess.py:1093-1152
    (DaxProcesser._fit_spots_by_segmentation: per cell id, bounding-box
    crop (+pad), fit the crop, shift coords to the FOV frame, keep spots
    whose position lands inside the cell mask)
  * bounding boxes             segmentation_tools/cell.py
    (segmentation_mask_2_bounding_box)
  * per-chromosome crop fit    classes/__init__.py:57-90, 3642-3730

Whole-FOV seeding ranks every candidate against one global dynamic
threshold, so dim in-nucleus spots lose to bright spots elsewhere once the
seed budget saturates; cropping first makes the seeding statistics local.

As in the JAX package, every crop has one shape (the largest padded box,
rounded up to a multiple of 8 per axis), centred on its cell's box.  The
crops are fitted one after another on the image's device: ``get_seeds``
(the exact classifier, ``seed_classify`` on the card) and
``iter_fit_seed_points`` (``gather_cubes``' ball entry and ``lm_fit``) per
crop.  The boxes come from one pass over the label volume on its device
(``scatter_reduce`` of each positive voxel's index per label); their
padding, the crop shape and the origins are the JAX package's host NumPy
arithmetic, ``np.round`` (half to even) included.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import as_tensor, host_array
from .gaussian_fit import iter_fit_seed_points
from .seeding import get_seeds


def segmentation_bounding_boxes(labels, pad: int = 3, device=None
                                ) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """cell id -> (lo, hi) inclusive-exclusive bounding box, padded and
    clipped to the volume (reference segmentation_mask_2_bounding_box).
    NumPy labels go to `device` (default the card); a tensor stays where
    it is."""
    lab = as_tensor(labels, device)
    shape = tuple(int(s) for s in lab.shape)
    flat = lab.reshape(-1)
    where = torch.nonzero(flat > 0).squeeze(1)
    if where.numel() == 0:
        return {}
    ids, inv = torch.unique(flat[where].to(torch.int64), return_inverse=True)
    plane = shape[1] * shape[2]
    axes = (where // plane, (where // shape[2]) % shape[1],
            where % shape[2])
    k = ids.shape[0]
    lo = torch.stack([torch.zeros(k, dtype=torch.int64, device=lab.device)
                      .scatter_reduce(0, inv, a, "amin", include_self=False)
                      for a in axes], dim=1)
    hi = torch.stack([torch.zeros(k, dtype=torch.int64, device=lab.device)
                      .scatter_reduce(0, inv, a, "amax", include_self=False)
                      for a in axes], dim=1)
    ids, lo, hi = host_array(ids), host_array(lo), host_array(hi)
    out = {}
    for cid, l, h in zip(ids, lo, hi):
        out[int(cid)] = (np.maximum([int(a) - pad for a in l], 0),
                         np.minimum([int(a) + 1 + pad for a in h], shape))
    return out


def _common_crop_shape(boxes, volume_shape, multiple: int = 8
                       ) -> Tuple[int, ...]:
    """One crop shape covering every box, rounded up per axis."""
    ext = np.max([hi - lo for lo, hi in boxes], axis=0)
    ext = np.minimum(-(-ext // multiple) * multiple, volume_shape)
    return tuple(int(e) for e in ext)


def fit_spots_in_crops(im, origins, crop_size: Tuple[int, int, int],
                       max_num_seeds: int = 64,
                       th_seed: float = 500.0,
                       radius: int = 5,
                       lm_iters: int = 30,
                       n_max_iter: int = 8,
                       dynamic_niters: int = 10,
                       min_dynamic_seeds: int = 1,
                       gfilt_size: float = 0.75,
                       background_gfilt_size: float = 7.5,
                       device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Seed + fit fixed-size crops of one stack, coordinates in the FOV
    frame.

    im: (Z, X, Y); origins: (N, 3) crop corners (clamped so that crops
    stay in bounds).  Returns (spots (N, max_num_seeds, 11), valid (N,
    max_num_seeds)) on the image's device; one crop is in flight at a
    time."""
    imf = as_tensor(im, device).to(torch.float32)
    dev = imf.device
    cs = np.asarray(crop_size, np.int64)
    org = np.clip(host_array(origins).astype(np.int64).reshape(-1, 3), 0,
                  np.asarray(imf.shape, np.int64)[None] - cs[None])
    spots, valid = [], []
    for o in org:
        crop = imf[o[0]:o[0] + cs[0], o[1]:o[1] + cs[1],
                   o[2]:o[2] + cs[2]].contiguous()
        seeds = get_seeds(crop, max_num_seeds=max_num_seeds,
                          th_seed=th_seed, gfilt_size=gfilt_size,
                          background_gfilt_size=background_gfilt_size,
                          dynamic_niters=dynamic_niters,
                          min_dynamic_seeds=min_dynamic_seeds)
        res = iter_fit_seed_points(crop, seeds.coords.to(torch.float32),
                                   seeds.valid, radius=radius,
                                   lm_iters=lm_iters, n_max_iter=n_max_iter)
        sp = res.spots.clone()
        sp[:, 1:4] += torch.as_tensor(o.astype(np.float32), device=dev)
        spots.append(sp)
        valid.append(res.valid)
    if not spots:
        return (torch.zeros((0, max_num_seeds, 11), device=dev),
                torch.zeros((0, max_num_seeds), dtype=torch.bool,
                            device=dev))
    return torch.stack(spots), torch.stack(valid)


def fit_spots_by_segmentation(im, labels,
                              th_seed: float = 500.0,
                              num_spots: Optional[int] = None,
                              crop_pad: int = 3,
                              segment_search_radius: int = 3,
                              drift=None, device=None,
                              **fit_kwargs
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit spots independently inside every segmented cell.

    Behavior target: DaxProcesser._fit_spots_by_segmentation
    (classes/preprocess.py:1093-1152): per cell, crop the padded bounding
    box (translated by `drift` when the mask comes from another round),
    fit the crop, map coordinates back to the FOV frame, and keep spots
    whose (rounded, radius-searched) position carries the cell's label.
    Returns (spots (M, 11) float32, cell_ids (M,) int32) on the image's
    device (`device`, default the card, for NumPy input)."""
    from ..analysis.partition import spots_to_labels

    imt = as_tensor(im, device)
    dev = imt.device
    lab = as_tensor(labels, dev).to(dev)
    empty = (torch.zeros((0, 11), device=dev),
             torch.zeros(0, dtype=torch.int32, device=dev))
    boxes = segmentation_bounding_boxes(lab, pad=crop_pad)
    if not boxes:
        return empty
    cids = sorted(boxes)
    crop_size = _common_crop_shape([boxes[c] for c in cids],
                                   tuple(lab.shape))
    drift = np.zeros(3) if drift is None else host_array(drift)
    # the crop is centred on each cell's box (the reference crops the
    # exact padded box; the common crop covers it by construction)
    origins = []
    for c in cids:
        lo, hi = boxes[c]
        ctr = (lo + hi) / 2.0 + drift
        origins.append(np.round(ctr - np.asarray(crop_size) / 2.0))
    origins = np.asarray(origins, np.int32)

    spots, valid = fit_spots_in_crops(
        imt, origins, crop_size, max_num_seeds=int(num_spots or 64),
        th_seed=th_seed, **fit_kwargs)
    owner = torch.as_tensor(np.asarray(cids, np.int32), device=dev)[
        :, None].expand(valid.shape)[valid]
    sp = spots[valid]
    if not sp.shape[0]:
        return empty
    coords = (sp[:, 1:4].double() - torch.as_tensor(
        np.asarray(drift, np.float64), device=dev)).to(torch.float32)
    got = spots_to_labels(lab, coords, torch.ones(sp.shape[0],
                                                  dtype=torch.bool,
                                                  device=dev),
                          search_radius=segment_search_radius)
    keep = got == owner
    return sp[keep], owner[keep]


def fit_spots_around_centers(im, centers,
                             crop_size: Tuple[int, int, int] = (16, 32, 32),
                             th_seed: float = 300.0,
                             max_num_seeds: int = 32,
                             device=None, **fit_kwargs
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit spots in fixed crops around chromosome coordinates (reference
    _fit_single_image, classes/__init__.py:57-90 +
    _multi_fitting_for_chromosome :3642-3730).  Returns (spots (N_centers,
    max_num_seeds, 11) in the FOV frame, valid mask)."""
    centers = host_array(centers).astype(float)
    origins = np.round(centers - np.asarray(crop_size) / 2.0).astype(
        np.int32)
    return fit_spots_in_crops(im, origins,
                              tuple(int(c) for c in crop_size),
                              max_num_seeds=max_num_seeds, th_seed=th_seed,
                              device=device, **fit_kwargs)
