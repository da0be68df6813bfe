"""Compartment analysis: AB projection, density clouds, region scores.

The counterpart of ``imageanalysis3_tpu/analysis/compartments.py``.
Behavior targets (reference ImageAnalysis3):
  * spot normalization / PCA alignment   compartment_tools/scoring.py:13-50
  * AB-axis max projection               compartment_tools/scoring.py:52-108
  * density clouds + scores              compartment_tools/scoring.py:110-420

The JAX package's jitted functions are float32 tensor functions here, on
the device of their input (NumPy input goes to `device`, default the
card); each takes leading batch dims (chromosomes) where the JAX function
takes one cloud, and every slice of a batch is that cloud's result.  The
sign of an eigenvector is free, so PCA-rotated coordinates agree with the
JAX package's up to a sign per axis.  ``ab_compartment_eigenscore`` is
float64 on the device, as the JAX package's NumPy is float64 on the host.

A density cloud is a sum of closed-form Gaussians on a (2r)^3 grid.  Each
Gaussian is the product of its three axes' factors, so the sum over spots
is one float32 matrix product per cloud, (N, G^2)^T @ (N, G), instead of an
(N, G^3) array: exp(a + b + c) against exp(a) exp(b) exp(c) differ in the
last bits only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..decode.scoring import norm
from ..device import as_tensor
from ..ops.filters import full_f32_matmul, nanquantile

f32 = torch.float32
f64 = torch.float64

#: bytes of the (chunk, N, G^2) factor products one density batch may hold
_DENSITY_CHUNK_BYTES = 1 << 29


def _masked_mean_cov(x: torch.Tensor, valid: torch.Tensor):
    """(…, N, D) points -> (centred points, (…, D, D) covariance) over the
    valid rows, each divided by max(count, 1) as the JAX package does."""
    v = valid[..., None]
    n = valid.sum(dim=-1).clamp_min(1).to(x.dtype)[..., None]
    mean = torch.where(v, x, 0.0).sum(dim=-2) / n
    centred = x - mean[..., None, :]
    c0 = torch.where(v, centred, 0.0)
    with full_f32_matmul():
        cov = torch.einsum("...ni,...nj->...ij", c0, c0) / n[..., None]
    return centred, cov


def normalize_center_spots(zxys, valid, pca_align: bool = False,
                           scaling: float = 1.0, device=None) -> torch.Tensor:
    """Centre (and optionally PCA-align) each chromosome's spot cloud,
    (…, N, 3) with (…, N) validity; invalid rows come out NaN."""
    zxys = as_tensor(zxys, device).to(f32)
    valid = as_tensor(valid, zxys.device).to(torch.bool)
    centred, cov = _masked_mean_cov(zxys, valid)
    if pca_align:
        _, vecs = torch.linalg.eigh(cov)
        with full_f32_matmul():
            centred = centred @ vecs.flip(-1)        # descending variance
    return torch.where(valid[..., None], centred * scaling, float("nan"))


def ab_axis_projection(zxys, valid, a_mask, b_mask,
                       device=None) -> torch.Tensor:
    """Rotate coordinates so the (A mean - B mean) axis is coordinate 0 and
    the other two are PCA-aligned (an orthonormal basis, as the JAX
    package builds it); (…, N, 3) in, invalid rows NaN."""
    zxys = as_tensor(zxys, device).to(f32)
    dev = zxys.device
    valid = as_tensor(valid, dev).to(torch.bool)
    va = valid & as_tensor(a_mask, dev).to(torch.bool)
    vb = valid & as_tensor(b_mask, dev).to(torch.bool)

    def mean_of(m):
        n = m.sum(dim=-1).clamp_min(1).to(f32)[..., None]
        return torch.where(m[..., None], zxys, 0.0).sum(dim=-2) / n

    axis = mean_of(va) - mean_of(vb)
    axis = axis / norm(axis).clamp_min(1e-12)[..., None]
    e0 = torch.tensor([1.0, 0.0, 0.0], dtype=f32, device=dev)
    e1 = torch.tensor([0.0, 1.0, 0.0], dtype=f32, device=dev)
    helper = torch.where((axis[..., :1].abs() < 0.9), e0, e1)
    u = torch.linalg.cross(axis, helper)
    u = u / norm(u).clamp_min(1e-12)[..., None]
    w = torch.linalg.cross(axis, u)
    basis = torch.stack([axis, u, w], dim=-1)           # (…, 3, 3)
    with full_f32_matmul():
        proj = zxys @ basis
    t, cov = _masked_mean_cov(proj[..., 1:3], valid)
    _, vecs = torch.linalg.eigh(cov)
    with full_f32_matmul():
        tail = t @ vecs.flip(-1)
    out = torch.cat([proj[..., :1], tail], dim=-1)
    return torch.where(valid[..., None], out, float("nan"))


def spots_to_density(zxys, valid, grid_radius: int = 30, sigma: float = 2.0,
                     voxel: float = 1.0, device=None) -> torch.Tensor:
    """(…, N, 3) spot clouds -> (…, G, G, G) summed-Gaussian densities on a
    centred (2r)^3 grid, each normalised to sum 1 (reference
    convert_spots_to_cloud, normalize_pdf form).  Batches of clouds run in
    chunks that hold at most ~512 MB of factor products."""
    zxys = torch.nan_to_num(as_tensor(zxys, device).to(f32))
    valid = as_tensor(valid, zxys.device).to(torch.bool)
    lead, n = zxys.shape[:-2], zxys.shape[-2]
    g = 2 * grid_radius
    flat_z = zxys.reshape(-1, n, 3)
    flat_v = valid.reshape(-1, n)
    grid = (torch.arange(-grid_radius, grid_radius, dtype=f32,
                         device=zxys.device) * voxel + voxel / 2)
    out = torch.empty((flat_z.shape[0], g, g, g), dtype=f32,
                      device=zxys.device)
    chunk = max(1, _DENSITY_CHUNK_BYTES // max(1, n * g * g * 4))
    for b0 in range(0, flat_z.shape[0], chunk):
        z = flat_z[b0:b0 + chunk]
        d = grid[None, None, None, :] - z[..., None]          # (B, N, 3, G)
        e = torch.exp(-0.5 * (d * d) / sigma ** 2)
        e = e * flat_v[b0:b0 + chunk, :, None, None].to(f32)
        zx = (e[:, :, 0, :, None] * e[:, :, 1, None, :]).reshape(
            z.shape[0], n, g * g)
        with full_f32_matmul():
            dens = (zx.transpose(1, 2) @ e[:, :, 2, :]).reshape(-1, g, g, g)
        total = dens.sum(dim=(1, 2, 3)).clamp_min(1e-12)
        out[b0:b0 + chunk] = dens / total[:, None, None, None]
    return out.reshape(*lead, g, g, g)


def compartment_scores(zxys, valid, a_mask, b_mask, grid_radius: int = 30,
                       sigma: float = 2.0, voxel: float = 1.0,
                       device=None) -> torch.Tensor:
    """Per-spot log density ratio between the A and B compartment clouds
    (positive = A-like), (…, N) for (…, N, 3) clouds; invalid spots NaN.
    Batches run a chunk of chromosomes at a time, so only a chunk's
    densities are held."""
    zxys = as_tensor(zxys, device).to(f32)
    dev = zxys.device
    valid = as_tensor(valid, dev).to(torch.bool)
    a_mask = as_tensor(a_mask, dev).to(torch.bool)
    b_mask = as_tensor(b_mask, dev).to(torch.bool)
    lead, n = zxys.shape[:-2], zxys.shape[-2]
    g = 2 * grid_radius
    flat = [t.reshape(-1, n, *t.shape[len(lead) + 1:])
            for t in torch.broadcast_tensors(zxys, valid[..., None],
                                             a_mask[..., None],
                                             b_mask[..., None])]
    z, v, a, b = flat[0], flat[1][..., 0], flat[2][..., 0], flat[3][..., 0]
    g0 = -grid_radius * voxel + voxel / 2
    idx = torch.round((torch.nan_to_num(z) - g0) / voxel).clamp(0, g - 1)
    idx = idx.to(torch.int64)
    fi = (idx[..., 0] * g + idx[..., 1]) * g + idx[..., 2]
    score = torch.empty(z.shape[:2], dtype=f32, device=dev)
    chunk = max(1, _DENSITY_CHUNK_BYTES // max(1, 4 * n * g * g))
    for b0 in range(0, z.shape[0], chunk):
        sl = slice(b0, b0 + chunk)
        dens_a = spots_to_density(z[sl], v[sl] & a[sl], grid_radius, sigma,
                                  voxel).reshape(-1, g ** 3)
        dens_b = spots_to_density(z[sl], v[sl] & b[sl], grid_radius, sigma,
                                  voxel).reshape(-1, g ** 3)
        score[sl] = (torch.log(dens_a.gather(1, fi[sl]).clamp_min(1e-12))
                     - torch.log(dens_b.gather(1, fi[sl]).clamp_min(1e-12)))
    score = torch.where(v, score, float("nan"))
    return score.reshape(*lead, n)


def ab_compartment_eigenscore(distmap, valid=None,
                              device=None) -> torch.Tensor:
    """Population AB score: the leading eigenvector of the correlation of
    the expected-normalised distance map, oriented so its sum is >= 0,
    NaN at invalid regions (float64 on the device).  The expected distance
    of each genomic separation is the median of that diagonal's finite
    entries; the JAX package's (R, R) loop is one masked expression."""
    dm = as_tensor(distmap, device).to(f64)
    dev, r = dm.device, dm.shape[0]
    fin = torch.isfinite(dm)
    valid = fin.all(dim=1) if valid is None else \
        as_tensor(valid, dev).to(torch.bool)
    nan = float("nan")
    i = torch.arange(r, device=dev)
    sep = torch.arange(1, r, device=dev)
    cols = i[None, :] + sep[:, None]                       # (R-1, R)
    diag = dm[i[None, :].expand_as(cols), cols.clamp(max=r - 1)]
    diag = torch.where((cols < r) & torch.isfinite(diag), diag, nan)
    expected = torch.cat([torch.full((1,), nan, dtype=f64, device=dev),
                          nanquantile(diag, 0.5, dim=1)])
    s = (i[:, None] - i[None, :]).abs()
    e = expected[s]
    use = (s > 0) & torch.isfinite(e) & (e > 0) & fin
    obs = torch.where(fin, torch.where(use, dm / e, 1.0), nan)
    ok = ~torch.isnan(obs)
    cnt = ok.sum(dim=1, keepdim=True).to(f64)
    mu = torch.where(ok, obs, 0.0).sum(dim=1, keepdim=True) / cnt
    dev2 = torch.where(ok, obs - mu, 0.0)
    sd = torch.sqrt((dev2 * dev2).sum(dim=1, keepdim=True) / cnt) + 1e-12
    z = torch.where(torch.isfinite(obs), (obs - mu) / sd, 0.0)
    corr = z @ z.T / r
    _, vecs = torch.linalg.eigh(corr)
    ev = vecs[:, -1]
    if float(torch.nansum(ev)) < 0:
        ev = -ev
    return torch.where(valid, ev, nan)


def winsorize(scores, l_per: float = 5.0, u_per: float = 5.0,
              normalize: bool = False) -> np.ndarray:
    """Clamp scores to their [l_per, 100 - u_per] percentiles over the
    finite entries, optionally min-max normalise (NaN stays NaN).  Host
    NumPy, as in the JAX package: one score per region."""
    s = np.asarray(scores, np.float64).copy()
    finite = np.isfinite(s)
    if finite.any():
        lo = np.percentile(s[finite], l_per)
        hi = np.percentile(s[finite], 100.0 - u_per)
        s[finite] = np.clip(s[finite], lo, hi)
        if normalize:
            mn, mx = np.nanmin(s), np.nanmax(s)
            s = (s - mn) / max(mx - mn, 1e-12)
    return s


def randomize_index_dict(index_dict: dict, key1: str = "A", key2: str = "B",
                         rng: "np.random.Generator | None" = None) -> dict:
    """Shuffle the union of two compartments' region indices back into two
    groups of the original sizes (the null control); `rng` is a NumPy
    generator, so the same generator draws the JAX package's groups."""
    for k in (key1, key2):
        if k not in index_dict:
            raise KeyError(f"{k} not in index_dict")
    rng = np.random.default_rng() if rng is None else rng
    i1 = np.asarray(index_dict[key1], np.int64)
    i2 = np.asarray(index_dict[key2], np.int64)
    both = np.concatenate([i1, i2])
    perm = rng.permutation(len(both))
    return {key1: np.sort(both[perm[:len(i1)]]),
            key2: np.sort(both[perm[len(i1):]])}


def density_overlaps(d1, d2, method: str = "geometric",
                     device=None) -> float:
    """Bhattacharyya-style overlap of two density clouds (float64 on the
    device)."""
    if method != "geometric":
        raise ValueError(f"unknown overlap method {method!r}")
    d1 = as_tensor(d1, device).to(f64)
    d2 = as_tensor(d2, d1.device).to(f64)
    return float(torch.nansum(torch.sqrt(d1 * d2))
                 / torch.sqrt(torch.nansum(d1) * torch.nansum(d2)))
