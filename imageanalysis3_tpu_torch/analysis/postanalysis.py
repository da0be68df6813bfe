"""Post-analysis statistics: hull-enclosure bootstrap, genomic scaling,
density-cloud scores, spot standardisation.

The counterpart of ``imageanalysis3_tpu/analysis/postanalysis.py``
(reference postanalysis.py: is_in_hull :158-187, Bootstrap_*_in_domain
:190-330, region_genomic_scaling :330-392, score_from_density :665-677,
local_maximum_in_density :698-713; spot_tools/translating.py:12-93).

Membership in conv(X) is the convex problem min_{lambda in simplex}
||X^T lambda - p||, solved by 64 away-step Frank-Wolfe iterations in
float32 (ties in argmin and argmax go to the first index, as in JAX).  The
bootstrap is one batched (chromosomes x samples) Frank-Wolfe on the
device.  JAX draws each sample's subset with ``jax.random.permutation``;
those bits cannot be reproduced here, so the bootstrap is two functions:
:func:`bootstrap_probs`, the core, takes the subsets as an explicit
(C, n_iter, k) index tensor, and :func:`bootstrap_spots_in_domain` draws
them with a ``torch.Generator`` made from `seed` (on the host, so every
device gets the same subsets) and calls it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..decode.scoring import norm
from ..device import as_tensor
from ..ops.filters import full_f32_matmul, maximum_filter, nanquantile

f32 = torch.float32
f64 = torch.float64


# ---------------------------------------------------------------------------
# Point-in-convex-hull via Frank-Wolfe
# ---------------------------------------------------------------------------


def _frank_wolfe(pts: torch.Tensor, valid: torch.Tensor, p: torch.Tensor,
                 n_iters: int) -> torch.Tensor:
    """The point of conv(pts[valid]) nearest p (…, 3) after `n_iters`
    away-step Frank-Wolfe iterations from the valid centroid, pts (…, N, 3)
    already zeroed where invalid."""
    n_valid = valid.sum(dim=-1)
    w = valid.to(f32) / n_valid.clamp_min(1).to(f32)[..., None]
    with full_f32_matmul():
        for _ in range(n_iters):
            x = (w[..., None, :] @ pts)[..., 0, :]                 # (…, 3)
            g = (pts @ (x - p)[..., :, None])[..., 0]              # (…, N)
            gv = torch.where(valid, g, float("inf"))
            s = torch.argmin(gv, dim=-1, keepdim=True)
            ga = torch.where(w > 0, g, -float("inf"))
            v = torch.argmax(ga, dim=-1, keepdim=True)
            gw = (g[..., None, :] @ w[..., :, None])[..., 0, 0]
            gap_fw = gw - gv.gather(-1, s)[..., 0]
            gap_aw = ga.gather(-1, v)[..., 0] - gw
            use_fw = (gap_fw >= gap_aw)[..., None]
            e_s = torch.zeros_like(w).scatter_(-1, s, 1.0)
            e_v = torch.zeros_like(w).scatter_(-1, v, 1.0)
            d = torch.where(use_fw, e_s - w, w - e_v)
            wv = w.gather(-1, v)
            gmax = torch.where(use_fw, 1.0,
                               wv / (1.0 - wv).clamp_min(1e-12))[..., 0]
            step = (d[..., None, :] @ pts)[..., 0, :]
            denom = (step * step).sum(dim=-1)
            num = ((p - x)[..., None, :] @ step[..., :, None])[..., 0, 0]
            gamma = torch.minimum(
                (num / denom.clamp_min(1e-12)).clamp_min(0.0), gmax)
            # one rounding, as XLA's fused multiply-add gives it: a drop
            # step must leave the same residual weight on its vertex
            w = (w.to(f64) + gamma[..., None].to(f64) * d.to(f64)
                 ).to(f32).clamp_min(0.0)
            w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-12)
        return (w[..., None, :] @ pts)[..., 0, :]


def _hull_distance(pts: torch.Tensor, valid: torch.Tensor, p: torch.Tensor,
                   n_iters: int) -> torch.Tensor:
    """|p - _frank_wolfe(...)|, inf where fewer than 4 points are valid."""
    dist = norm(_frank_wolfe(pts, valid, p, n_iters) - p)
    return torch.where(valid.sum(dim=-1) >= 4, dist, float("inf"))


def hull_distance(points, valid, p, n_iters: int = 64,
                  device=None) -> torch.Tensor:
    """Euclidean distance from `p` (…, 3) to conv(points[valid]) (…, N, 3)
    by away-step Frank-Wolfe, inf where fewer than 4 points are valid."""
    points = as_tensor(points, device)
    dev = points.device
    valid = as_tensor(valid, dev).to(torch.bool)
    pts = torch.where(valid[..., None], points, 0.0).to(f32)
    return _hull_distance(pts, valid, as_tensor(p, dev).to(f32),
                          int(n_iters))


def is_in_hull(ref_zxys, zxy, remove_self: bool = True, tol: float = 1e-3,
               n_iters: int = 64, device=None) -> bool:
    """True iff `zxy` lies inside the convex hull of `ref_zxys` (NaN rows
    dropped, the query point removed when `remove_self`, fewer than 4
    points False); `tol` is the hull-distance cut relative to the cloud's
    radius around the query."""
    pts = as_tensor(np.asarray(ref_zxys, np.float32), device)
    p = as_tensor(np.asarray(zxy, np.float32), pts.device)
    if p.ndim != 1:
        raise ValueError("zxy must be one point (1d)")
    valid = ~torch.isnan(pts).any(dim=1)
    if remove_self:
        valid &= ~(pts == p[None]).all(dim=1)
    clean = torch.nan_to_num(pts)
    d = hull_distance(clean, valid, p, n_iters=n_iters)
    radii = norm(clean - p[None])[valid]
    scale = max(float(radii.max()) if radii.numel() else 1.0, 1.0)
    return bool(float(d) < tol * scale)


# ---------------------------------------------------------------------------
# Bootstrap enclosure probabilities
# ---------------------------------------------------------------------------


def bootstrap_probs(dm_zxys, spot_zxys, subsets, tol: float = 1e-3,
                    fw_iters: int = 64, device=None) -> torch.Tensor:
    """(C, D, 3) domain coordinates, (C, 3) query spots and (C, n_iter, k)
    subset indices -> (C,) enclosure probabilities: for each sample the
    hull of the chosen domain points (NaN rows and points equal to the
    query dropped) encloses the spot iff its distance is below tol x the
    cloud's radius around the spot (at least 1); NaN spots give NaN."""
    dm_zxys = as_tensor(dm_zxys, device).to(f32)
    dev = dm_zxys.device
    spots = as_tensor(spot_zxys, dev).to(f32)
    subsets = as_tensor(subsets, dev).to(torch.int64)
    c, n_pts = dm_zxys.shape[:2]
    base = (~torch.isnan(dm_zxys).any(dim=-1)
            & ~(dm_zxys == spots[:, None]).all(dim=-1))             # (C, D)
    pts = torch.nan_to_num(dm_zxys)
    radius = torch.where(base, norm(pts - spots[:, None]), 0.0).amax(dim=1)
    cut = tol * radius.clamp_min(1.0)
    chosen = torch.zeros((c, subsets.shape[1], n_pts), dtype=torch.bool,
                         device=dev).scatter_(-1, subsets, True)
    valid = chosen & base[:, None]
    masked = torch.where(valid[..., None], pts[:, None], 0.0)
    d = _hull_distance(masked, valid,
                       spots[:, None].expand(-1, valid.shape[1], -1),
                       int(fw_iters))
    hits = (d < cut[:, None]).to(f32)
    return torch.where(torch.isnan(spots).any(dim=1), float("nan"),
                       hits.mean(dim=1))


def draw_bootstrap_subsets(n_chrom: int, n_iter: int, n_points: int,
                           sampling_size: int, seed: int = 0) -> torch.Tensor:
    """(n_chrom, n_iter, sampling_size) int64 subsets without replacement,
    each the prefix of a uniform permutation, from a CPU
    ``torch.Generator`` seeded with `seed`."""
    g = torch.Generator().manual_seed(int(seed))
    keys = torch.rand((n_chrom, n_iter, n_points), generator=g)
    return torch.argsort(keys, dim=-1)[..., :sampling_size]


def _sampling_size(n_domain: int, p_bootstrap: float) -> int:
    if not 0.0 < p_bootstrap < 1.0:
        raise ValueError(f"p_bootstrap {p_bootstrap} not in (0, 1)")
    size = int(np.ceil(n_domain * p_bootstrap))
    return size - 1 if size == n_domain else size


def bootstrap_spots_in_domain(chrom_zxy_list, spot_zxy_list,
                              domain_indices: Sequence[int],
                              p_bootstrap: float = 0.25, n_iter: int = 100,
                              tol: float = 1e-3, fw_iters: int = 64,
                              seed: int = 0, device=None) -> torch.Tensor:
    """Per-chromosome probability that a spot is enclosed by the convex
    hull of a bootstrap subsample (ceil(len * p_bootstrap), capped one
    below the full set) of the domain's points; NaN spots give NaN.
    `chrom_zxy_list` is a list of (R, 3) traces or one (C, R, 3) array."""
    if len(chrom_zxy_list) != len(spot_zxy_list):
        raise ValueError("chromosome and spot lists differ in length")
    domain_indices = np.asarray(domain_indices, np.int64)
    chroms = chrom_zxy_list if isinstance(chrom_zxy_list, torch.Tensor) \
        else as_tensor(np.stack([np.asarray(z, np.float32)
                                 for z in chrom_zxy_list]), device)
    spots = spot_zxy_list if isinstance(spot_zxy_list, torch.Tensor) \
        else as_tensor(np.stack([np.asarray(s, np.float32)
                                 for s in spot_zxy_list]), chroms.device)
    if domain_indices.max() >= chroms.shape[1]:
        raise ValueError("domain index out of range")
    k = _sampling_size(len(domain_indices), p_bootstrap)
    dm = chroms[:, torch.as_tensor(domain_indices, device=chroms.device)]
    subsets = draw_bootstrap_subsets(dm.shape[0], int(n_iter), dm.shape[1],
                                     k, seed)
    return bootstrap_probs(dm, spots, subsets.to(chroms.device), tol,
                           fw_iters)


def bootstrap_regions_in_domain(chrom_zxy_list, region_index: int,
                                domain_indices: Sequence[int],
                                **kwargs) -> torch.Tensor:
    """Enclosure probabilities of region `region_index` inside the domain,
    per chromosome (the region's own coordinate is the query)."""
    if isinstance(chrom_zxy_list, torch.Tensor):
        spots = chrom_zxy_list[:, int(region_index)]
    else:
        spots = [np.asarray(z)[int(region_index)] for z in chrom_zxy_list]
    return bootstrap_spots_in_domain(chrom_zxy_list, spots, domain_indices,
                                     **kwargs)


# ---------------------------------------------------------------------------
# Genomic scaling
# ---------------------------------------------------------------------------


def region_genomic_scaling(coordinates, inds: Sequence[int],
                           genomic_distance_matrix, device=None
                           ) -> Tuple[float, float, float]:
    """(slope, intercept, r) of the log-log regression of physical on
    genomic pairwise distance over the selected regions (upper-triangle
    pairs, non-finite and non-positive dropped); `coordinates` is an
    (R, R) distance map or (R, 3) points (float64 on the device)."""
    mat = as_tensor(coordinates, device).to(f64)
    dev = mat.device
    if mat.ndim != 2:
        raise ValueError("coordinates must be 2d")
    if mat.shape[0] != mat.shape[1]:
        if mat.shape[1] != 3:
            raise ValueError("coordinates must be a square distance map "
                             "or (R, 3) points")
        mat = norm(mat[:, None, :] - mat[None, :, :])
    inds = torch.as_tensor(np.asarray(inds, np.int64), device=dev)
    sel = mat[inds][:, inds]
    gen = as_tensor(genomic_distance_matrix, dev).to(f64)[inds][:, inds]
    iu = torch.triu_indices(len(inds), len(inds), 1, device=dev)
    x, y = gen[iu[0], iu[1]], sel[iu[0], iu[1]]
    keep = torch.isfinite(x) & torch.isfinite(y) & (x > 0) & (y > 0)
    x, y = torch.log(x[keep]), torch.log(y[keep])
    if x.numel() < 2:
        raise ValueError("not enough finite pairs to regress")
    vx = x - x.mean()
    vy = y - y.mean()
    sxy, sxx, syy = (vx * vy).sum(), (vx * vx).sum(), (vy * vy).sum()
    slope = sxy / sxx
    intercept = y.mean() - slope * x.mean()
    r = sxy / torch.sqrt(sxx * syy)
    return float(slope), float(intercept), float(r)


# ---------------------------------------------------------------------------
# Density-cloud scores
# ---------------------------------------------------------------------------


def score_from_density(dens_a, dens_b, cutoff_percentile: float = 50.0,
                       device=None) -> torch.Tensor:
    """A/B demixing score: the geometric mean of each cloud's fraction not
    overlapped by the other, each thresholded at the given percentile of
    its positive voxels (float32; 1 = demixed, 0 = identical)."""
    dens_a = as_tensor(dens_a, device).to(f32)
    dens_b = as_tensor(dens_b, dens_a.device).to(f32)
    q = float(np.float32(cutoff_percentile) / np.float32(100.0))

    def mask_of(d):
        th = nanquantile(torch.where(d > 0, d, float("nan")).reshape(-1), q)
        return d > th

    a, b = mask_of(dens_a), mask_of(dens_b)
    na = a.sum().clamp_min(1)
    nb = b.sum().clamp_min(1)
    nab = (a & b).sum()
    return torch.sqrt((1.0 - nab / na) * (1.0 - nab / nb))


def _density_maxima_mask(density: torch.Tensor, seeding_window: int,
                         intensity_ratio: float) -> torch.Tensor:
    """(Z, X, Y) mask of window-maximal voxels whose finite-difference
    Hessian is negative definite and whose intensity exceeds
    intensity_ratio x the brightest window maximum."""
    d = density.to(f32)
    is_max = maximum_filter(d, seeding_window) == d
    grads = torch.gradient(d)
    h = torch.stack([torch.stack(torch.gradient(g), dim=0) for g in grads],
                    dim=0)                                   # (3, 3, Z, X, Y)
    hm = h.permute(2, 3, 4, 0, 1)
    hm = 0.5 * (hm + hm.transpose(-1, -2))
    neg_def = (torch.linalg.eigvalsh(hm) < 0).all(dim=-1)
    peak = torch.where(is_max, d, -float("inf")).max()
    return is_max & neg_def & (d > intensity_ratio * peak)


def local_maximum_in_density(density, seeding_window: int = 10,
                             intensity_ratio: float = 0.25,
                             device=None) -> torch.Tensor:
    """(K, 3) int64 coordinates of Hessian-verified local maxima of a
    density cloud, in raster order."""
    mask = _density_maxima_mask(as_tensor(density, device),
                                int(seeding_window), float(intensity_ratio))
    return torch.nonzero(mask)


def normalize_center_spots(spots, distance_zxy: Sequence[float] = (200.0,
                                                                  108.0,
                                                                  108.0),
                           center_zero: bool = True,
                           scale_variance: bool = False,
                           pca_align: bool = True, scaling: float = 1.0,
                           return_pca: bool = False, device=None):
    """Standardise one chromosome's spots in 3D (float64 on the device):
    `(N, 3)` zxy, `(N, 4)` hzxy or 11-column rows (coordinates 1:4 and
    widths 5:8 rescaled to isotropic units); centre, optionally scale the
    total variance, rotate onto the principal axes of the clean rows
    (descending variance, each axis signed toward its largest
    projection).  Returns the copy (and the (3, 3) components when
    `return_pca`)."""
    spots = as_tensor(spots, device).to(f64).clone()
    dev = spots.device
    ncol = spots.shape[1]
    stds = None
    if ncol == 3:
        coords = spots.clone()
    elif ncol == 4:
        coords = spots[:, -3:].clone()
    else:
        d = torch.as_tensor(np.asarray(distance_zxy, np.float64)[:3],
                            device=dev)
        adj = d / d.min()
        coords = spots[:, 1:4] * adj[None]
        stds = spots[:, 5:8] * adj[None]

    ok = ~torch.isnan(coords)
    center = torch.where(ok, coords, 0.0).sum(dim=0) / ok.sum(dim=0)
    if center_zero:
        coords = coords - center
        center = torch.zeros(3, dtype=f64, device=dev)
    if scale_variance:
        mu = torch.where(ok, coords, 0.0).sum(dim=0) / ok.sum(dim=0)
        dv = torch.where(ok, coords - mu, 0.0)
        var = (dv * dv).sum(dim=0) / ok.sum(dim=0)
        total = torch.sqrt(torch.nansum(var))
        coords = coords / total * scaling
        if stds is not None:
            stds = stds / total * scaling
    else:
        coords = coords * scaling
        if stds is not None:
            stds = stds * scaling

    model = None
    if pca_align:
        clean = ~torch.isnan(coords).any(dim=1)
        x = coords[clean] - center
        if x.shape[0] >= 3:
            xc = x - x.mean(dim=0)
            cov = xc.T @ xc / (x.shape[0] - 1)
            w, v = torch.linalg.eigh(cov)
            model = v[:, torch.argsort(w, stable=True).flip(0)]
            proj = x @ model
            big = proj.abs().argmax(dim=0)
            lead = proj[big, torch.arange(3, device=dev)]
            sign = torch.where(proj.abs().sum(dim=0) > 0, torch.sign(lead),
                               1.0)
            model = model * sign[None]
            coords[clean] = x @ model + center

    if ncol == 3:
        out = coords
    elif ncol == 4:
        out = spots.clone()
        out[:, -3:] = coords
    else:
        out = spots.clone()
        out[:, 1:4] = coords
        out[:, 5:8] = stds
    if return_pca:
        return out, model
    return out
