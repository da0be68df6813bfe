"""Nuclei segmentation on DAPI stacks.

The counterpart of ``imageanalysis3_tpu/segmentation/nuclei.py``.
Behavior targets (reference ImageAnalysis3):
  * DAPI watershed segmentation   visual_tools.py:1092-1606
    (DAPI_segmentation / DAPI_convoluted_segmentation: smooth, threshold,
    seed, random-walker/watershed expansion, size screens)
  * Cellpose wrappers             segmentation_tools/cell.py:31-362
    (Cellpose_Segmentation_Psedu3D / _3D); the learned counterparts are
    ``segmentation.learned`` and ``segmentation.cellpose_net``.

Segmentation is three device steps -- Otsu's threshold from a 256-bin
histogram, seed detection by the local-max seeding, and watershed
expansion as block-synchronous geodesic label propagation (a (dist, label)
min-plus relaxation over the 6-neighbourhood inside the foreground mask)
-- then host screens over per-label bounding boxes that one pass over the
label volume on its device computes.

Propagation stops as the JAX package's loop does: after ``max_iters``
sweeps, or after the first sweep that changed no label (distances may
still be falling then).  The flag is read on the host every
``CHECK_EVERY`` sweeps; the sweeps after the first label-quiet one, up to
that read, change nothing, so the result is that of a per-sweep read.
Each sweep visits the axes 0, 1, 2 and in each the directions +1 then -1,
with a strict ``<`` on float32 sums, so ties go the same way.

NumPy inputs go to `device` (default the CUDA card); tensors stay where
they are.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import as_tensor, host_array
from ..ops.filters import gaussian_filter
from ..ops.gaussian_fit import select_sparse_centers
from ..ops.seeding import get_seeds

#: distance of a voxel no seed has reached (float32, as the JAX package's)
_FAR = 1e9
#: sweeps between the host's reads of propagation's stop flag
CHECK_EVERY = 8
#: sweeps the last call of :func:`propagate_labels` ran
_last_sweeps = [0]


def otsu_threshold(im, n_bins: int = 256, device=None) -> torch.Tensor:
    """Otsu's threshold via a device histogram (between-class variance
    maximization) -- the reference's adaptive DAPI cut
    (visual_tools.py:1133+).  The counts are exact integers; the rest is
    the JAX package's float32 arithmetic: the bin scale, truncation to
    int32, the cumulative sums and the middle of the maximum's plateau
    (an empty inter-mode gap makes the objective flat)."""
    imf = as_tensor(im, device).to(torch.float32)
    lo = imf.min()
    hi = imf.max()
    # a true float32 division: a Python number over a tensor is computed
    # as the number times the tensor's reciprocal
    scale = torch.tensor(float(n_bins - 1), device=imf.device) \
        / torch.clamp(hi - lo, min=1e-12)
    idx = ((imf - lo) * scale).to(torch.int32).clamp(0, n_bins - 1)
    hist = torch.bincount(idx.reshape(-1).to(torch.int64),
                          minlength=n_bins).to(torch.float32)
    p = hist / torch.clamp(hist.sum(), min=1.0)
    omega = torch.cumsum(p, 0)
    centers = ((torch.arange(n_bins, dtype=torch.float32, device=imf.device)
                + 0.5) / scale + lo)
    mu = torch.cumsum(p * centers, 0)
    mu_t = mu[-1]
    sigma_b = (mu_t * omega - mu) ** 2 / torch.clamp(
        omega * (1.0 - omega), min=1e-12)
    is_max = sigma_b >= sigma_b.max() * (1.0 - 1e-6)
    k_first = int(torch.argmax(is_max.to(torch.int8)))
    k_last = n_bins - 1 - int(torch.argmax(is_max.flip(0).to(torch.int8)))
    return centers[(k_first + k_last) // 2]


def propagate_labels(seed_labels, mask, max_iters: int = 256,
                     step_costs: Tuple[float, float, float] = (1.0, 1.0,
                                                               1.0),
                     device=None) -> torch.Tensor:
    """Geodesic nearest-seed labeling inside `mask` (watershed expansion).

    seed_labels: (Z, X, Y) int, > 0 at seed voxels; mask: foreground.
    Block-synchronous min-plus relaxation of (distance, label) over the
    6-neighbourhood -- the replacement for skimage random_walker /
    watershed growing (reference segmentation_tools/cell.py:300-360,
    visual_tools.py:1210+).  ``step_costs`` are per-axis geodesic step
    lengths (the voxel pitch makes the propagation metrically isotropic).

    Each sweep reads the previous sweep's state and updates a copy in the
    order axis 0, 1, 2, direction +1 then -1; a sweep after the first one
    that changed no label is frozen on the device, and the host reads the
    flag every CHECK_EVERY sweeps.  Returns int32 labels, 0 outside
    `mask`."""
    seeds = as_tensor(seed_labels, device)
    dev = seeds.device
    mask = as_tensor(mask, dev).to(device=dev, dtype=torch.bool)
    lab = torch.where(seeds > 0, seeds, 0).to(torch.int32)
    dist = torch.where(seeds > 0, 0.0, _FAR).to(torch.float32)
    best_d, best_l = torch.empty_like(dist), torch.empty_like(lab)
    labelled = torch.empty_like(mask)
    active = torch.ones((), dtype=torch.bool, device=dev)
    sweeps = torch.zeros((), dtype=torch.int64, device=dev)
    # per axis, buffers for a shifted distance and its "better" mask
    bufs = {}
    for axis in range(3):
        if dist.shape[axis] > 1:
            shape = list(dist.shape)
            shape[axis] -= 1
            bufs[axis] = (torch.empty(shape, dtype=torch.float32, device=dev),
                          torch.empty(shape, dtype=torch.bool, device=dev))
    for it in range(max_iters):
        best_d.copy_(dist)
        best_l.copy_(lab)
        torch.gt(lab, 0, out=labelled)
        labelled &= active
        for axis, (nd_buf, better) in bufs.items():
            n = dist.shape[axis]
            cost = float(step_costs[axis])
            for src, dst in ((0, 1), (1, 0)):       # direction +1, -1
                nd = torch.add(dist.narrow(axis, src, n - 1), cost,
                               out=nd_buf)
                td = best_d.narrow(axis, dst, n - 1)
                tl = best_l.narrow(axis, dst, n - 1)
                torch.lt(nd, td, out=better)
                better &= mask.narrow(axis, dst, n - 1)
                better &= labelled.narrow(axis, src, n - 1)
                torch.where(better, nd, td, out=td)
                torch.where(better, lab.narrow(axis, src, n - 1), tl, out=tl)
        sweeps += active
        active = active & (best_l != lab).any()
        dist, best_d = best_d, dist
        lab, best_l = best_l, lab
        if (it + 1) % CHECK_EVERY == 0 and not bool(active):
            break
    _last_sweeps[0] = int(sweeps)
    return torch.where(mask, lab, 0)


def propagation_sweeps() -> int:
    """Sweeps the last call of :func:`propagate_labels` ran (the label-quiet
    one included, the frozen ones not)."""
    return _last_sweeps[0]


def label_sizes(labels, max_labels: int = 128, device=None
                ) -> torch.Tensor:
    """(max_labels+1,) int32 voxel counts per label 0..max_labels."""
    lab = as_tensor(labels, device).reshape(-1).to(torch.int64)
    inside = (lab >= 0) & (lab <= max_labels)
    idx = torch.where(inside, lab, max_labels + 1)
    return torch.bincount(idx, minlength=max_labels + 2)[
        :max_labels + 1].to(torch.int32)


def _step_costs(pixel_sizes) -> Tuple[float, float, float]:
    """Per-axis geodesic step lengths normalized to the finest pitch."""
    if pixel_sizes is None:
        return (1.0, 1.0, 1.0)
    p = np.asarray(pixel_sizes, float)
    p = p / p.min()
    return tuple(float(v) for v in p)


def segment_nuclei(dapi_im,
                   smooth_sigma: float = 3.0,
                   threshold: Optional[float] = None,
                   seed_min_distance: float = 20.0,
                   max_num_nuclei: int = 64,
                   min_size_voxels: int = 200,
                   max_iters: int = 256,
                   seed_th: Optional[float] = None,
                   pixel_sizes: Optional[Tuple[float, float, float]] = None,
                   device=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DAPI stack -> (labels (Z, X, Y) int32, seed coords, seed validity).

    Pipeline (reference DAPI_segmentation, visual_tools.py:1092-1276):
    gaussian smooth (sigma in physical units, scaled per axis by the voxel
    pitch) -> Otsu foreground -> local-max seeding thinned to
    `seed_min_distance` -> geodesic label propagation -> components under
    `min_size_voxels` dropped.  The default seed threshold is
    std(smooth) * 0.5 + 1e-3, a float32 reduction."""
    im = as_tensor(dapi_im, device).to(torch.float32)
    if pixel_sizes is not None:
        p = np.asarray(pixel_sizes, float)
        sigma = tuple(float(smooth_sigma) * p.min() / p)
    else:
        sigma = smooth_sigma
    smooth = gaussian_filter(im, sigma)
    th = otsu_threshold(smooth) if threshold is None else threshold
    mask = smooth > th

    if seed_th is None:
        seed_th = float(torch.std(smooth, correction=0)) * 0.5 + 1e-3
    seeds = get_seeds(smooth, max_num_seeds=max_num_nuclei,
                      th_seed=seed_th, gfilt_size=0.0,
                      background_gfilt_size=smooth_sigma * 4,
                      min_edge_distance=0, remove_hot_pixel=False)
    coords = seeds.coords
    c = coords.clamp_min(0).long()
    valid = seeds.valid & mask[c[:, 0], c[:, 1], c[:, 2]]
    valid = valid & select_sparse_centers(coords.to(torch.float32), valid,
                                          seed_min_distance)

    shape = smooth.shape
    n = coords.shape[0]
    ids = torch.arange(1, n + 1, dtype=torch.int32, device=im.device)
    z = coords[:, 0].clamp(0, shape[0] - 1).long()
    x = coords[:, 1].clamp(0, shape[1] - 1).long()
    y = coords[:, 2].clamp(0, shape[2] - 1).long()
    seed_vol = torch.zeros(shape, dtype=torch.int32, device=im.device)
    seed_vol.view(-1).scatter_reduce_(0, (z * shape[1] + x) * shape[2] + y,
                                      torch.where(valid, ids, 0), "amax")

    labels = propagate_labels(seed_vol, mask, max_iters=max_iters,
                              step_costs=_step_costs(pixel_sizes))
    keep = label_sizes(labels, max_labels=n) >= min_size_voxels
    keep[0] = False
    labels = torch.where(keep[labels.clamp(0, n).long()], labels, 0)
    return labels, coords, valid


def shape_ratio(label_mask_2d) -> float:
    """Area / perimeter^2 of one label's xy footprint -- the reference's
    roundness screen (visual_tools.py:1455-1495 min_shape_ratio; a disc
    scores ~1/(4*pi) ~= 0.08, snakes and debris score far lower)."""
    m = np.asarray(host_array(label_mask_2d), bool)
    area = int(m.sum())
    if area == 0:
        return 0.0
    pad = np.pad(m, 1)
    interior = (pad[:-2, 1:-1] & pad[2:, 1:-1]
                & pad[1:-1, :-2] & pad[1:-1, 2:])
    perimeter = int((m & ~interior).sum())
    return area / max(perimeter, 1) ** 2


def _label_bboxes(labels, device=None):
    """One pass over the volume on its device: per-label (sizes, bbox mins,
    bbox maxs) as NumPy int64 -- inclusive bounds, index 0 = background,
    an absent label's mins at int64's maximum and maxs at -1."""
    lab = as_tensor(labels, device)
    n = int(lab.max()) if lab.numel() else 0
    flat = lab.reshape(-1)
    where = torch.nonzero(flat).squeeze(1)
    ids = flat[where].to(torch.int64)
    sizes = torch.bincount(ids, minlength=n + 1)
    plane = lab.shape[1] * lab.shape[2]
    axes = (where // plane, (where // lab.shape[2]) % lab.shape[1],
            where % lab.shape[2])
    big = torch.iinfo(torch.int64).max
    mins = torch.stack([torch.full((n + 1,), big, dtype=torch.int64,
                                   device=lab.device)
                        .scatter_reduce(0, ids, a, "amin") for a in axes], 1)
    maxs = torch.stack([torch.full((n + 1,), -1, dtype=torch.int64,
                                   device=lab.device)
                        .scatter_reduce(0, ids, a, "amax") for a in axes], 1)
    return host_array(sizes), host_array(mins), host_array(maxs)


def screen_labels(labels, min_size_voxels: int = 0,
                  min_shape_ratio: float = 0.0,
                  boundary_margin: int = 0, device=None) -> torch.Tensor:
    """Drop labels that fail the reference's post-segmentation screens
    (DAPI_convoluted_segmentation, visual_tools.py:1440-1530): too few
    voxels, too snake-like in xy footprint (`min_shape_ratio`), or any
    xy support within `boundary_margin` px of the FOV edge
    (remove_fov_boundary).  Returns a relabeled (1..K) int32 volume."""
    lab = as_tensor(labels, device)
    sizes, mins, maxs = _label_bboxes(lab)
    remap = np.zeros(len(sizes), np.int32)
    nxt = 1
    for l in range(1, len(sizes)):
        if sizes[l] == 0 or sizes[l] < min_size_voxels:
            continue
        if boundary_margin > 0:
            if (mins[l, 1] < boundary_margin or mins[l, 2] < boundary_margin
                    or maxs[l, 1] >= lab.shape[1] - boundary_margin
                    or maxs[l, 2] >= lab.shape[2] - boundary_margin):
                continue
        if min_shape_ratio > 0:
            box = tuple(slice(int(mins[l, a]), int(maxs[l, a]) + 1)
                        for a in range(3))
            if shape_ratio((lab[box] == l).any(dim=0)) < min_shape_ratio:
                continue
        remap[l] = nxt
        nxt += 1
    return torch.as_tensor(remap, device=lab.device)[lab.long()]


def _peak_seeds(im: np.ndarray, mask: np.ndarray, k: int,
                min_distance: float) -> np.ndarray:
    """Up to k brightest mutually-distant voxels inside `mask`
    (deterministic peak picking with suppression), on the host."""
    pos = np.stack(np.nonzero(mask), axis=1)
    if len(pos) == 0:
        return np.zeros((0, 3), np.int64)
    vals = im[tuple(pos.T)].astype(np.float64).copy()
    picks = []
    alive = np.ones(len(pos), bool)
    for _ in range(k):
        if not alive.any():
            break
        i = int(np.argmax(np.where(alive, vals, -np.inf)))
        picks.append(pos[i])
        d2 = ((pos - pos[i]) ** 2).sum(1)
        alive &= d2 >= min_distance ** 2
    return np.asarray(picks, np.int64).reshape(-1, 3)


def split_oversized_nuclei(im, labels, max_size_voxels: int,
                           shrink_percent: float = 15.0,
                           max_iter: int = 4,
                           seed_min_distance: float = 12.0,
                           max_seeds_per_label: int = 3,
                           smooth_sigma: float = 2.0,
                           max_iters: int = 256,
                           pixel_sizes=None, device=None) -> torch.Tensor:
    """Iteratively split labels larger than `max_size_voxels`: shrink
    each oversized label to its top-(100-shrink_percent)% intensity
    core, re-seed the core's intensity peaks, and re-propagate within
    the original label support -- the reference's shrink/conv/random-walker
    splitting loop (visual_tools.py:1496-1580: shrink_percent, max_iter).
    Labels that produce a single core seed are kept whole.

    The smoothing, the boxes and the propagation run on the device; each
    oversized label's core quantile and peak picking run on the host over
    its bounding box (NumPy's quantile, as the JAX package's)."""
    imt = as_tensor(im, device).to(torch.float32)
    dev = imt.device
    im_s = gaussian_filter(imt, smooth_sigma)
    labels = as_tensor(labels, dev).to(dev).clone()
    for _ in range(max(max_iter, 1)):
        sizes, mins, maxs = _label_bboxes(labels)
        oversized = [l for l in range(1, len(sizes))
                     if sizes[l] > max_size_voxels]
        if not oversized:
            break
        changed = False
        nxt = int(labels.max()) + 1
        for l in oversized:
            box = tuple(slice(int(mins[l, a]), int(maxs[l, a]) + 1)
                        for a in range(3))
            sub_lab = labels[box]
            m = sub_lab == l
            m_np = host_array(m)
            sub_im = host_array(im_s[box])
            thr = np.quantile(sub_im[m_np], shrink_percent / 100.0)
            core = m_np & (sub_im >= thr)
            seeds = _peak_seeds(sub_im, core, max_seeds_per_label,
                                seed_min_distance)
            if len(seeds) < 2:
                continue
            seed_vol = np.zeros(sub_lab.shape, np.int32)
            new_ids = [l] + [nxt + j for j in range(len(seeds) - 1)]
            nxt += len(seeds) - 1
            for sid, (z, x, y) in zip(new_ids, seeds):
                seed_vol[z, x, y] = sid
            sub = propagate_labels(torch.as_tensor(seed_vol, device=dev), m,
                                   max_iters=max_iters,
                                   step_costs=_step_costs(pixel_sizes))
            sub_lab.copy_(torch.where(m, sub.to(sub_lab.dtype), sub_lab))
            changed = True
        if not changed:
            break
    return labels


def segment_cells(dapi_im, polyt_im=None,
                  pixel_sizes: Tuple[float, float, float] = (250.0, 108.0,
                                                             108.0),
                  smooth_sigma: float = 3.0,
                  seed_min_distance: float = 20.0,
                  max_num_nuclei: int = 64,
                  min_size_voxels: int = 200,
                  max_iters: int = 256,
                  polyt_threshold: Optional[float] = None,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-channel cell segmentation -> (cell labels, nucleus labels).

    Behavior target: Cellpose_Segmentation_3D.run
    (segmentation_tools/cell.py:192-362): segment nuclei on DAPI, then
    expand each nucleus through the polyT cytoplasm signal (the
    reference's random_walker with the nucleus masks as seeds).
    Anisotropy enters as per-axis geodesic step costs; the polyT expansion
    is the same label propagation restricted to the polyT foreground."""
    dapi = as_tensor(dapi_im, device).to(torch.float32)
    nuc_labels, _coords, _valid = segment_nuclei(
        dapi, smooth_sigma=smooth_sigma,
        seed_min_distance=seed_min_distance,
        max_num_nuclei=max_num_nuclei,
        min_size_voxels=min_size_voxels, max_iters=max_iters,
        pixel_sizes=pixel_sizes)
    if polyt_im is None:
        return nuc_labels, nuc_labels
    polyt = gaussian_filter(as_tensor(polyt_im, dapi.device)
                            .to(device=dapi.device, dtype=torch.float32),
                            smooth_sigma)
    th = (otsu_threshold(polyt) if polyt_threshold is None
          else polyt_threshold)
    fg = (polyt > th) | (nuc_labels > 0)
    cell_labels = propagate_labels(nuc_labels, fg, max_iters=max_iters,
                                   step_costs=_step_costs(pixel_sizes))
    return cell_labels, nuc_labels


def merge_z_layer_masks(layer_masks, overlap_th: float = 0.9) -> np.ndarray:
    """Merge per-layer 2D label masks into consistent 3D cells by
    xy-projection overlap, on the host.

    Behavior target: Cellpose_Segmentation_Psedu3D.merge_3d_masks
    (segmentation_tools/cell.py:114-191), as the JAX package simplifies it:
    union ids whose projection overlap (relative to the smaller) reaches
    `overlap_th`, relabel densely."""
    masks = np.asarray(host_array(layer_masks))
    ids = np.unique(masks)
    ids = ids[ids > 0]
    proj = {int(i): (masks == i).any(axis=0) for i in ids}
    parent = {int(i): int(i) for i in ids}

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    ids = [int(i) for i in ids]
    for a_i, a in enumerate(ids):
        for b in ids[a_i + 1:]:
            inter = np.sum(proj[a] & proj[b])
            if inter == 0:
                continue
            frac = inter / min(proj[a].sum(), proj[b].sum())
            if frac >= overlap_th:
                parent[find(b)] = find(a)
    roots = {i: find(i) for i in ids}
    dense = {r: k + 1 for k, r in enumerate(sorted(set(roots.values())))}
    out = np.zeros_like(masks)
    for i in ids:
        out[masks == i] = dense[roots[i]]
    return out


def interpolate_z_masks(z_masks, z_coords, target_z_coords,
                        mode: str = "nearest") -> np.ndarray:
    """Resample label masks from one z grid onto another, on the host.

    Behavior target: interploate_z_masks (segmentation_tools/cell.py:
    614-656): exact-match layers (to 3 decimals) copy through; otherwise
    'nearest' picks the closest source layer."""
    z_masks = np.asarray(host_array(z_masks))
    z_coords = np.round(np.asarray(z_coords, float), 3)
    target = np.round(np.asarray(target_z_coords, float), 3)
    out = []
    for fz in target:
        hit = np.where(z_coords == fz)[0]
        if len(hit):
            out.append(z_masks[hit[0]])
        elif mode == "nearest":
            out.append(z_masks[int(np.argmin(np.abs(z_coords - fz)))])
        else:
            raise ValueError(f"unsupported mode: {mode}")
    return np.asarray(out)
