"""Local-maximum seeding with dynamic thresholding, fixed-capacity output.

The counterpart of ``imageanalysis3_tpu/ops/seeding.py``.  Behavior target:
reference spot_tools/fitting.py:20-154 (get_seeds):
  * foreground = gaussian(0.75); candidate iff equal to its 3^3 maximum
  * background = gaussian(7.5); candidate iff not equal to its 3^3 minimum
  * signal = foreground - background must exceed th_seed
  * dynamic threshold decay th*(1 - i/n) until >= min_dynamic_seeds found
  * edge seeds (< min_edge_distance from borders) removed
  * "hot pixel" seeds (same xy in >= 3 z-layers) removed
  * sort by height, cap at max_num_seeds

The retry loop over thresholds is one pass: each candidate voxel gets the
smallest decay level at which it qualifies, and a cumulative histogram over
levels picks the level reaching `min_dynamic_seeds`.  Output is a
fixed-capacity seed table with a validity count.

Which classifier runs is the config's choice, on every device: with
``pyramid_bg`` (the default) and a config the pyramid classifier takes, it
runs (ops/seed_kernels.py: the CUDA kernel for a CUDA tensor, its plain
version for a CPU tensor); otherwise the exact classifier runs in plain
PyTorch, in x-slabs for planes wider than ``2 * slab_x``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .filters import (_pad_axis, _window_reduce_interior, gaussian_filter,
                      maximum_filter, minimum_filter)
from .seed_kernels import fused_seed_classify_pyramid, pyramid_supported


class Seeds(NamedTuple):
    """Fixed-capacity seed table."""

    coords: torch.Tensor     # (cap, 3) int32 zxy, padded with -1
    heights: torch.Tensor    # (cap,) f32, padded with 0
    valid: torch.Tensor      # (cap,) bool
    count: torch.Tensor      # () int32 -- number of valid seeds
    threshold: torch.Tensor  # () f32 -- the dynamic threshold actually used
    saturated: torch.Tensor  # () bool -- candidate capacity overflowed


def _level_diff_hist(tile: torch.Tensor, th_seed, x0, core_x: int,
                     full_shape, gfilt_size: float,
                     background_gfilt_size: float, filt_size: int,
                     min_edge_distance: int, n_lvl: int):
    """Per-voxel qualified signal + level histogram for one x-slab.

    `tile`: (Z, core_x + 2*halo, Y) with `halo` columns of valid neighbor
    data (or boundary padding) on each side; `x0` is the global x index of
    the first core column.
    """
    max_im = gaussian_filter(tile, gfilt_size) if gfilt_size else tile
    min_im = (gaussian_filter(tile, background_gfilt_size)
              if background_gfilt_size else tile)
    return _classify_from_blurs(max_im, min_im, th_seed, x0, core_x,
                                full_shape, filt_size, min_edge_distance,
                                n_lvl)


def _classify_from_blurs(max_im, min_im, th_seed, x0, core_x: int,
                         full_shape, filt_size: int,
                         min_edge_distance: int, n_lvl: int):
    """Stencil + threshold-level classification of the two blurred stacks
    -> (qdiff, hist): qdiff is fg - bg where the voxel qualifies (local
    max, inside the edge margin) and -inf elsewhere; hist counts the
    qualifying voxels per threshold-decay level."""
    halo = (max_im.shape[1] - core_x) // 2
    if min_edge_distance >= filt_size // 2:
        # the discarded border covers the filter's reach, so the
        # identity-padded window reduce is exact where it matters
        max_ft = _window_reduce_interior(max_im, filt_size, "max") == max_im
        min_ft = _window_reduce_interior(min_im, filt_size, "min") != min_im
    else:
        max_ft = maximum_filter(max_im, filt_size) == max_im
        min_ft = minimum_filter(min_im, filt_size) != min_im
    local_max = max_ft & min_ft
    diff = max_im - min_im
    if halo:
        local_max = local_max[:, halo:-halo]
        diff = diff[:, halo:-halo]

    z, _, y = full_shape
    d = min_edge_distance
    dev = diff.device
    if d > 0:
        zi = torch.arange(z, device=dev)[:, None, None]
        xi = x0 + torch.arange(core_x, device=dev)[None, :, None]
        yi = torch.arange(y, device=dev)[None, None, :]
        edge_ok = ((zi >= d) & (zi <= z - d)
                   & (xi >= d) & (xi <= full_shape[1] - d)
                   & (yi >= d) & (yi <= y - d))
        qualify = local_max & edge_ok
    else:
        qualify = local_max

    # level(p) = smallest i with diff >= th*(1 - i/n); th clamped positive
    th = torch.tensor(float(max(np.float32(th_seed), np.float32(1e-6))),
                      dtype=torch.float32, device=dev)
    frac = 1.0 - diff[qualify] / th
    level = torch.ceil(frac * n_lvl).clamp(0, n_lvl).to(torch.int64)
    hist = torch.bincount(level, minlength=n_lvl + 1)[:n_lvl]
    return (torch.where(qualify, diff, float("-inf")),
            hist.to(torch.int32))


def _radius(sigma):
    return int(4.0 * float(sigma) + 0.5) if sigma else 0


def get_seeds(im: torch.Tensor,
              max_num_seeds: int = 1024,
              th_seed=150.0,
              gfilt_size: float = 0.75,
              background_gfilt_size: float = 7.5,
              filt_size: int = 3,
              min_edge_distance: int = 2,
              use_dynamic_th: bool = True,
              dynamic_niters: int = 10,
              min_dynamic_seeds: int = 1,
              remove_hot_pixel: bool = True,
              hot_pixel_th: int = 3,
              slab_x: int = 1024,
              pyramid_bg: bool = False) -> Seeds:
    """Seed local maxima of `im` (Z, X, Y) -> fixed-capacity table."""
    imf = im.to(torch.float32)
    shape = tuple(imf.shape)
    dev = imf.device
    n_lvl = dynamic_niters if use_dynamic_th else 1
    if not n_lvl < 127:
        raise ValueError("dynamic_niters must be < 127")
    th_f = float(max(np.float32(float(th_seed)), np.float32(1e-6)))

    halo = max(_radius(gfilt_size), _radius(background_gfilt_size)) \
        + (filt_size // 2)
    args = (th_f, gfilt_size, background_gfilt_size, filt_size,
            min_edge_distance, n_lvl)

    if pyramid_bg and pyramid_supported(shape, gfilt_size,
                                        background_gfilt_size, filt_size,
                                        min_edge_distance):
        qdiff, counts = fused_seed_classify_pyramid(
            imf, gfilt_size, background_gfilt_size, th_f, n_lvl,
            min_edge_distance=min_edge_distance)
    elif shape[1] > 2 * slab_x and shape[1] % slab_x == 0:
        padded = _pad_axis(imf, 1, halo, halo, "reflect")
        qs, hs = [], []
        for i in range(shape[1] // slab_x):
            tile = padded[:, i * slab_x:(i + 1) * slab_x + 2 * halo]
            q, h = _level_diff_hist(tile, args[0], i * slab_x, slab_x,
                                    shape, *args[1:])
            qs.append(q)
            hs.append(h)
        qdiff = torch.cat(qs, dim=1)
        counts = torch.stack(hs).sum(dim=0)
    else:
        qdiff, counts = _level_diff_hist(imf, args[0], 0, shape[1], shape,
                                         *args[1:])

    cum = torch.cumsum(counts, dim=0)
    # chosen level: first reaching min_dynamic_seeds, else the last level
    reach = cum >= min_dynamic_seeds
    chosen = torch.where(reach.any(), reach.to(torch.int32).argmax(),
                         n_lvl - 1)
    th = torch.tensor(th_f, dtype=torch.float32, device=dev)
    chosen_f = chosen.to(torch.float32)
    chosen_th = th * (1.0 - chosen_f / n_lvl)

    def in_budget(q):
        """level(q) <= chosen with the classification's exact arithmetic
        (q = -inf maps to level +inf -> excluded)."""
        return torch.ceil((1.0 - q / th) * n_lvl) <= chosen_f

    # brightest-first extraction: 2x2x2 block-max reduce, then hierarchical
    # top-k over the 8x-smaller array.  Two qualifying 3^3 local maxima are
    # >= 2 apart in every axis, so each 2x2x2 block holds at most one
    # in-budget seed; the winner's voxel is recovered from the 8 block
    # members afterwards.  The budget threshold commutes with max, so it is
    # applied to the reduced array; the hot-pixel (xy-duplicate) screen is
    # deferred to candidate recovery, where it is a (Z, cap, 8) column
    # gather instead of a full-stack pass.
    pads = [(-s) % 2 for s in shape]
    z2, x2, y2 = [(s + p) // 2 for s, p in zip(shape, pads)]
    red = qdiff
    for ax, p in enumerate(pads):
        if p:
            red = _pad_axis(red, ax, 0, p, "constant", float("-inf"))
    red = red.reshape(z2, 2, x2, 2, y2, 2).amax(dim=(1, 3, 5))
    red = torch.where(in_budget(red), red, float("-inf")).reshape(-1)
    total = red.shape[0]
    row_cap = 16
    rows = max(1, min(16384, total // row_cap))
    cols = -(-total // rows)
    flat = _pad_axis(red, 0, 0, rows * cols - total, "constant",
                     float("-inf"))
    v1, i1 = torch.topk(flat.reshape(rows, cols), min(row_cap, cols), dim=1)
    flat1 = (torch.arange(rows, device=dev) * cols)[:, None] + i1
    # candidate count from the per-row top-k table
    n_sel = torch.isfinite(v1).sum()
    k2 = min(max_num_seeds, int(v1.numel()))
    hts, order = torch.topk(v1.reshape(-1), k2)
    block_idx = flat1.reshape(-1)[order]
    if k2 < max_num_seeds:
        hts = _pad_axis(hts, 0, 0, max_num_seeds - k2, "constant",
                        float("-inf"))
        block_idx = _pad_axis(block_idx, 0, 0, max_num_seeds - k2,
                              "constant", 0)
    bz = block_idx // (x2 * y2)
    brem = block_idx % (x2 * y2)
    bx = brem // y2
    by = brem % y2
    offs = torch.as_tensor(np.indices((2, 2, 2)).reshape(3, 8).T,
                           device=dev)                            # (8, 3)
    cz = bz[:, None] * 2 + offs[None, :, 0]
    cx = bx[:, None] * 2 + offs[None, :, 1]
    cy = by[:, None] * 2 + offs[None, :, 2]
    inb = (cz < shape[0]) & (cx < shape[1]) & (cy < shape[2])
    czc = cz.clamp_max(shape[0] - 1)
    cxc = cx.clamp_max(shape[1] - 1)
    cyc = cy.clamp_max(shape[2] - 1)
    cand_q = qdiff[czc, cxc, cyc]                                 # (cap, 8)
    # rows whose ranked block value is -inf are padding; recovery must not
    # resurrect them
    cand_ok = inb & in_budget(cand_q) & torch.isfinite(hts)[:, None]
    if remove_hot_pixel:
        # deferred hot screen: in-budget z-count of each candidate's column
        col_q = qdiff[:, cxc, cyc]                                # (Z, cap, 8)
        xy_cnt = in_budget(col_q).to(torch.int32).sum(dim=0)
        cand_ok = cand_ok & (xy_cnt < hot_pixel_th)
    cand = torch.where(cand_ok, cand_q, float("-inf"))
    pick = cand.argmax(dim=1)
    rows_i = torch.arange(cz.shape[0], device=dev)
    coords = torch.stack([cz[rows_i, pick], cx[rows_i, pick],
                          cy[rows_i, pick]], dim=1)
    # heights/validity from the RECOVERED voxel
    hts_rec = cand.amax(dim=1)
    valid = torch.isfinite(hts_rec)
    if remove_hot_pixel:
        # restore the by-height output contract over the surviving seeds
        order2 = torch.argsort(-torch.where(valid, hts_rec, float("-inf")),
                               stable=True)
        hts_rec = hts_rec[order2]
        coords = coords[order2]
        valid = valid[order2]
    hts = torch.where(valid, hts_rec, 0.0)
    coords = torch.where(valid[:, None], coords, -1)
    return Seeds(coords=coords.to(torch.int32), heights=hts, valid=valid,
                 count=valid.to(torch.int32).sum(),
                 threshold=chosen_th,
                 saturated=n_sel > max_num_seeds)
