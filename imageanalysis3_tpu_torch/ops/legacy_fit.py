"""Old-generation seeding/fitting API adapters.

The counterpart of ``imageanalysis3_tpu/ops/legacy_fit.py``: the
module-level function surface of the reference's ``visual_tools.py`` that
legacy notebooks call (``get_seed_points_base`` :348-382,
``fitsinglegaussian_fixed_width`` :151-203, ``fit_seed_points_base``
:204-259, ``get_STD_centers`` :260-347, ``fit_multi_gaussian``
:1969-2072), kept working against the batched engine: seeds from
``seeding.get_seeds`` (the config picks the classifier, the device picks
kernel or plain version), spots from ``gaussian_fit.iter_fit_seed_points``
(the ball gather and the LM fit).  The fixed-width fit is a 15-step
Gauss-Newton on (h, cz, cx, cy, bk) with a 5x5 solve, batched over spots in
plain float32 torch.  The JAX module's documented differences from the
reference hold here too: seeds come sorted by height, the subtract-refit
is block-synchronous, ``fit_multi_gaussian``'s regulariser knobs are
accepted and ignored, and ``get_STD_centers`` saves ``.npy``.  Results
come back in the reference's NumPy formats.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import as_tensor, host_array
from .filters import full_f32_matmul
from .gaussian_fit import gather_blocks, iter_fit_seed_points, neighbor_lists
from .seeding import get_seeds

__all__ = ["get_seed_points_base", "fitsinglegaussian_fixed_width",
           "fit_seed_points_base", "get_STD_centers", "fit_multi_gaussian"]

f32 = torch.float32


def _image(im, device) -> torch.Tensor:
    return as_tensor(im, device).to(f32)


def get_seed_points_base(im, gfilt_size: float = 0.75,
                         background_gfilt_size: float = 10.0,
                         filt_size: int = 3, th_seed: float = 300.0,
                         hot_pix_th: int = 0, return_h: bool = False,
                         max_num_seeds: int = 4096,
                         device=None) -> np.ndarray:
    """Old seeding entry: DoG local-max classifier at a single threshold
    -> (3, N) int seed coordinates [z; x; y] ((4, N) with the heights
    appended when `return_h`), sorted by height."""
    seeds = get_seeds(_image(im, device), max_num_seeds=max_num_seeds,
                      th_seed=th_seed, gfilt_size=gfilt_size,
                      background_gfilt_size=background_gfilt_size,
                      filt_size=filt_size, min_edge_distance=0,
                      use_dynamic_th=False, remove_hot_pixel=hot_pix_th > 0,
                      hot_pixel_th=max(hot_pix_th, 1))
    valid = host_array(seeds.valid)
    coords = host_array(seeds.coords)[valid].T.astype(np.int64)
    if return_h:
        return np.vstack([coords, host_array(seeds.heights)[valid][None]])
    return coords


# ---------------------------------------------------------------------------
# Fixed-width single-Gaussian fit (Gauss-Newton on (h, cz, cx, cy, bk))
# ---------------------------------------------------------------------------


def _median_sorted(s: torch.Tensor) -> torch.Tensor:
    """Median of each row of sorted `s` as ``jnp.median`` forms it:
    low * (1 - w) + high * w at position 0.5 * (n - 1)."""
    n = s.shape[-1]
    pos = 0.5 * (n - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    w = np.float32(pos - lo)
    return s[..., lo] * (np.float32(1.0) - w) + s[..., hi] * w


def _fixed_width_fit(pixels: torch.Tensor, coords: torch.Tensor,
                     mask: torch.Tensor, center0: torch.Tensor,
                     widths: torch.Tensor, n_approx: int = 10,
                     iters: int = 15) -> torch.Tensor:
    """Fixed-width Gaussians on N gathered pixel blocks (N, P) -> (N, 5)
    rows [|h|, cz, cx, cy, |bk|]: initial background and height from the
    medians of the `n_approx` dimmest and brightest pixels, then `iters`
    Gauss-Newton steps with a 1e-6 trace damping."""
    inf = float("inf")
    lo = torch.sort(torch.where(mask, pixels, inf), dim=-1).values
    hi = torch.sort(torch.where(mask, pixels, -inf), dim=-1).values
    bk0 = _median_sorted(lo[:, :n_approx])
    h0 = (_median_sorted(hi[:, -n_approx:]) - bk0).clamp_min(1e-3)
    p = torch.cat([h0[:, None], center0.to(f32), bk0[:, None]], dim=1)
    m = mask.to(f32)
    inv_w2 = 1.0 / (widths.to(f32) ** 2)
    eye = torch.eye(5, dtype=f32, device=pixels.device)
    with full_f32_matmul():
        for _ in range(iters):
            h, c, bk = p[:, 0:1], p[:, 1:4], p[:, 4:5]
            d = coords - c[:, None, :]
            q = d * d * inv_w2
            e = torch.exp(-0.5 * (q[..., 0] + q[..., 1] + q[..., 2]))
            r = (pixels - (bk + h * e)) * m
            jc = (h * e)[..., None] * d * inv_w2
            jac = torch.cat([e[..., None], jc, torch.ones_like(e)[..., None]],
                            dim=-1) * m[..., None]
            jtj = jac.transpose(1, 2) @ jac
            jtr = (jac.transpose(1, 2) @ r[..., None])[..., 0]
            tr = jtj.diagonal(dim1=1, dim2=2).sum(dim=1)
            damp = (1e-6 * tr + 1e-12)[:, None, None]
            p = p + torch.linalg.solve(jtj + damp * eye, jtr)
    return torch.cat([p[:, :1].abs(), p[:, 1:4], p[:, 4:5].abs()], dim=1)


def fitsinglegaussian_fixed_width(data, center, radius: int = 10,
                                  n_approx: int = 10,
                                  width_zxy: Sequence[float] = (1.8, 1.5,
                                                                1.5),
                                  device=None):
    """Old single-spot fitter -> (p, success), p = [h, z, x, y, bk, wz, wx,
    wy] with the widths echoed from `width_zxy`; (None, None) when the
    ball around the centre holds no pixel.  `center` None takes the median
    position of the `n_approx` brightest voxels."""
    im = _image(data, device)
    if center is None:
        order = torch.argsort(im.reshape(-1), stable=True)[-n_approx:]
        zxy = np.stack(np.unravel_index(host_array(order), tuple(im.shape)))
        center = np.median(zxy, axis=1)
    center = np.asarray(center, np.float64)
    pixels, coords, mask = gather_blocks(
        im, torch.as_tensor(np.round(center)[None].astype(np.int32),
                            device=im.device), radius)
    if not bool(mask.any()):
        return None, None
    widths = torch.as_tensor(np.asarray(width_zxy, np.float32),
                             device=im.device)
    p5 = _fixed_width_fit(pixels, coords, mask,
                          torch.as_tensor(center[None].astype(np.float32),
                                          device=im.device),
                          widths, n_approx=n_approx)
    return np.concatenate([host_array(p5[0]),
                           np.asarray(width_zxy, float)]), True


# ---------------------------------------------------------------------------
# Multi-spot fixed-width fit with Jacobi subtract-refit
# ---------------------------------------------------------------------------


def _fit_round(im: torch.Tensor, centers: torch.Tensor,
               heights: torch.Tensor, widths: torch.Tensor, radius: int,
               n_approx: int = 10, max_neighbors: int = 16) -> torch.Tensor:
    """Refit every spot with its neighbours' reconstructions subtracted
    from its pixel block -> (N, 5)."""
    n = centers.shape[0]
    base = torch.round(centers).to(torch.int32)
    pixels, coords, mask = gather_blocks(im, base, radius)
    nb_idx, nb_mask = neighbor_lists(
        base, torch.ones(n, dtype=torch.bool, device=im.device),
        max_neighbors=min(max_neighbors, n), radius=radius)
    inv_w2 = 1.0 / (widths.to(f32) ** 2)
    d = coords[:, None, :, :] - centers[nb_idx][:, :, None, :]   # N,K,P,3
    q = d * d * inv_w2
    e = torch.exp(-0.5 * (q[..., 0] + q[..., 1] + q[..., 2]))
    contrib = torch.where(nb_mask[..., None], heights[nb_idx][..., None] * e,
                          0.0)
    cleaned = pixels - contrib.sum(dim=1)
    return _fixed_width_fit(cleaned, coords, mask, centers, widths,
                            n_approx=n_approx)


def fit_seed_points_base(im, centers, width_z: float = 1.8,
                         width_xy: float = 1.5, radius_fit: int = 5,
                         n_max_iter: int = 10, max_dist_th: float = 0.25,
                         device=None) -> np.ndarray:
    """Old multi-spot fitter: fixed-width Gaussians refitted with their
    neighbours subtracted until the largest squared centre move is below
    `max_dist_th` (one host read a round).  `centers` is the seeding
    format (3, N); returns (N, 8) rows [h, z, x, y, bk, wz, wx, wy]."""
    z, x, y = np.asarray(centers)[:3]
    if len(x) == 0:
        return np.array([])
    imj = _image(im, device)
    dev = imj.device
    widths = torch.as_tensor([width_z, width_xy, width_xy], dtype=f32,
                             device=dev)
    cents = torch.as_tensor(np.stack([z, x, y], axis=1).astype(np.float32),
                            device=dev)
    heights = torch.zeros(cents.shape[0], dtype=f32, device=dev)
    p5 = None
    for _ in range(max(n_max_iter, 1)):
        prev = cents
        p5 = _fit_round(imj, cents, heights, widths, radius=radius_fit)
        cents = p5[:, 1:4]
        heights = p5[:, 0]
        if float(((cents - prev) ** 2).sum(dim=1).max()) < max_dist_th:
            break
    rows = host_array(p5)
    wrow = np.tile(np.asarray([width_z, width_xy, width_xy]),
                   (rows.shape[0], 1))
    return np.concatenate([rows, wrow], axis=1)


def get_STD_centers(im, seeds=None, th_seed: float = 150.0,
                    dynamic: bool = False, seed_by_per: bool = False,
                    th_seed_percentile: float = 95.0,
                    min_num_seeds: int = 1, remove_close_pts: bool = True,
                    close_threshold: float = 0.1, fit_radius: int = 5,
                    sort_by_h: bool = False, save: bool = False,
                    save_folder: str = "", save_name: str = "",
                    plt_val: bool = False, force: bool = False,
                    verbose: bool = False, max_num_seeds: int = 2048,
                    device=None) -> Optional[np.ndarray]:
    """Old bead-fitting entry: seed + fit one image -> (N, 3) zxy centres
    with NaN, out-of-bounds and mutually close points (squared distance
    below `close_threshold`) removed; None when nothing fits.  Saves go to
    ``.npy``."""
    imj = _image(im, device)
    dev = imj.device
    if seeds is None:
        s = get_seeds(imj, max_num_seeds=max_num_seeds, th_seed=th_seed,
                      use_dynamic_th=dynamic or seed_by_per,
                      min_dynamic_seeds=min_num_seeds)
        seeds_zxy = s.coords.to(f32)
        valid = s.valid
    else:
        arr = np.asarray(seeds, np.float64)
        # the (3|4, N) seeding-column format, never N rows of (z, x, y)
        if arr.ndim == 2 and arr.shape[0] in (3, 4) and arr.shape[1] != 3:
            arr = arr[:3].T
        seeds_zxy = torch.as_tensor(arr[:, :3].astype(np.float32),
                                    device=dev)
        valid = torch.ones(len(arr), dtype=torch.bool, device=dev)
    res = iter_fit_seed_points(imj, seeds_zxy, valid, radius=fit_radius)
    rows = res.spots[res.valid]
    if rows.shape[0] == 0:
        return None
    if sort_by_h:
        rows = rows[torch.as_tensor(
            np.argsort(host_array(rows[:, 0]))[::-1].copy(), device=dev)]
    beads = rows[:, 1:4]
    drop = torch.isnan(beads).any(dim=1)
    size = torch.as_tensor(tuple(imj.shape), dtype=f32, device=dev)
    drop |= (beads < 0).any(dim=1) | (beads >= size).any(dim=1)
    if remove_close_pts:
        dd = beads[:, None, :] - beads[None, :, :]
        d2 = dd[..., 0] ** 2 + dd[..., 1] ** 2 + dd[..., 2] ** 2
        drop |= (d2 < close_threshold).sum(dim=1) > 1     # includes self
    beads = host_array(beads[~drop])
    if save and save_name:
        os.makedirs(save_folder or ".", exist_ok=True)
        np.save(os.path.join(save_folder or ".",
                             save_name.replace(".pkl", ".npy")), beads)
    if verbose:
        print(f"- fitted {rows.shape[0]} points, kept {len(beads)}")
    return beads


def fit_multi_gaussian(im, seeds, width_zxy=(1.5, 2.0, 2.0),
                       fit_radius: int = 5,
                       height_sensitivity: float = 100.0,
                       expect_intensity: float = 500.0,
                       expect_weight: float = 1000.0,
                       th_to_end: float = 1e-7, n_max_iter: int = 10,
                       max_dist_th: float = 0.25, min_height: float = 100.0,
                       return_im: bool = False, verbose: bool = False,
                       device=None) -> np.ndarray:
    """Old multi-Gaussian fitter: the engine's full 11-column rows for
    (N, 3+) seed rows, kept where the height reaches `min_height` (0.05 x
    the image maximum when a tenth of it is below `min_height`)."""
    seeds = np.asarray(seeds, np.float64)
    if len(seeds) == 0:
        return np.zeros((0, 11), np.float32)
    imj = _image(im, device)
    peak = float(imj.max())
    if peak * 0.1 < min_height:
        min_height = peak * 0.05
    res = iter_fit_seed_points(
        imj, torch.as_tensor(seeds[:, :3].astype(np.float32),
                             device=imj.device),
        torch.ones(len(seeds), dtype=torch.bool, device=imj.device),
        radius=fit_radius, n_max_iter=n_max_iter, max_dist_th=max_dist_th)
    rows = host_array(res.spots)[host_array(res.valid)]
    rows = rows[rows[:, 0] >= min_height]
    if verbose:
        print(f"-- Multi-Fitting: {len(seeds)} seeds -> {len(rows)} kept")
    return rows
