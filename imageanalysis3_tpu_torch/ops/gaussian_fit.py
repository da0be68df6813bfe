"""Constrained 3D Gaussian spot fitting: batched Levenberg-Marquardt.

The counterpart of ``imageanalysis3_tpu/ops/gaussian_fit.py``.  Behavior
target: reference External/Fitting_v4.py:165-683 --
  * the 10-parameter constrained model (GaussianFit.calc_f :259-290):
    log background, log height, sigmoid-boxed center within +-delta of the
    seed, sigmoid-boxed squared widths in [min_w^2, max_w^2], and two
    sine-angles giving a full-covariance rotated anisotropic Gaussian;
  * natural parameter row [h, z, x, y, bk, wz, wx, wy, sin_t, sin_p, eps];
  * iterative fit-and-subtract (iter_fit_seed_points :559-683): fit each
    seed on the pixels it owns, then re-fit each spot against the image
    with all *other* reconstructions subtracted until centers move < 0.1 px.

Every spot is fit concurrently: pixels are gathered into fixed in-ball
blocks with bounds/ownership masks, and the LM engine is ops/lm_kernel.py
(the CUDA kernel for CUDA tensors, its plain version on the CPU).  The
sequential subtract-refit becomes block-synchronous (Jacobi) rounds.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .lm_kernel import (geometry_jacobian, lm_fit, quadform_coeffs, to_sine,
                        to_ws)

__all__ = ["FitResult", "iter_fit_seed_points", "init_params",
           "gaussian_model", "to_natural", "rebase_center_params",
           "ball_offsets", "gather_blocks", "neighbor_lists",
           "ownership_mask", "geometry_jacobian"]


def _to_center(cp, center_est, delta):
    # 2d/(1+e^x) - d  ==  d * tanh(-x/2)
    return center_est + delta * to_sine(cp)


def gaussian_model(params: torch.Tensor, coords: torch.Tensor,
                   center_est: torch.Tensor, delta: torch.Tensor,
                   min_w: float, max_w: float,
                   include_background: bool = True) -> torch.Tensor:
    """Model intensity at `coords` (N, P, 3) for constrained params (N, 10)
    (reference GaussianFit.p_ ordering [bk, h, c1p, c2p, c3p, w1p, w2p,
    w3p, pp, tp])."""
    delta = torch.as_tensor(delta, dtype=torch.float32,
                            device=params.device).expand(params.shape[0])
    c = _to_center(params[:, 2:5], center_est, delta[:, None])
    ws = to_ws(params[:, 5:8], min_w * min_w, max_w * max_w)
    p = to_sine(params[:, 8])
    t = to_sine(params[:, 9])
    a11, a22, a33, a12, a13, a23 = quadform_coeffs(
        t, p, 1.0 / ws[:, 0], 1.0 / ws[:, 1], 1.0 / ws[:, 2])
    d = coords - c[:, None, :]
    q = (a11[:, None] * d[..., 0] ** 2 + a22[:, None] * d[..., 1] ** 2
         + a33[:, None] * d[..., 2] ** 2
         + a12[:, None] * d[..., 0] * d[..., 1]
         + a13[:, None] * d[..., 0] * d[..., 2]
         + a23[:, None] * d[..., 1] * d[..., 2])
    peak = torch.exp(params[:, 1:2] - 0.5 * q)
    if include_background:
        return torch.exp(params[:, 0:1].clamp(-70.0, 70.0)) + peak
    return peak


def to_natural(params: torch.Tensor, center_est: torch.Tensor,
               delta: torch.Tensor, min_w: float, max_w: float,
               eps: torch.Tensor) -> torch.Tensor:
    """Constrained params (N, 10) -> (N, 11) rows [h, z, x, y, bk, wz, wx,
    wy, sin_t, sin_p, eps] (reference to_natural_paramaters :244-258)."""
    h = torch.exp(params[:, 1])
    bk = torch.exp(params[:, 0].clamp(-70.0, 70.0))
    c = _to_center(params[:, 2:5], center_est, delta[:, None])
    ws = torch.sqrt(to_ws(params[:, 5:8], min_w * min_w, max_w * max_w))
    p = to_sine(params[:, 8])
    t = to_sine(params[:, 9])
    return torch.stack([h, c[:, 0], c[:, 1], c[:, 2], bk, ws[:, 0],
                        ws[:, 1], ws[:, 2], t, p, eps], dim=1)


def init_params(pixels: torch.Tensor, mask: torch.Tensor,
                min_w: float, max_w: float, init_w: float,
                n_aprox: int = 10,
                coords: Optional[torch.Tensor] = None,
                center_est: Optional[torch.Tensor] = None,
                delta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Initial constrained params (N, 10) from pixel statistics (reference
    GaussianFit.__init__ :174-186); with `coords`/`center_est`/`delta` the
    center starts at the intensity-weighted centroid of the
    background-subtracted block (reference gfit_fast :433-490 moments)."""
    inf = float("inf")
    big = torch.where(mask, pixels, inf)
    small = torch.where(mask, pixels, -inf)
    lo = -torch.topk(-big, n_aprox, dim=1).values
    hi = torch.topk(small, n_aprox, dim=1).values
    n_valid = mask.to(torch.int32).sum(dim=1)
    k = n_valid.clamp(1, n_aprox).to(torch.float32)
    lo_mean = torch.where(torch.isfinite(lo), lo, 0.0).sum(dim=1) / k
    hi_mean = torch.where(torch.isfinite(hi), hi, 0.0).sum(dim=1) / k
    eps0 = float(np.exp(np.float32(-10.0)))
    bk = torch.log(lo_mean.clamp_min(eps0))
    h = torch.log(hi_mean.clamp_min(eps0))
    wsq = init_w * init_w
    wg = float(np.log(np.float32((max_w * max_w - wsq)
                                 / (wsq - min_w * min_w))))
    n = pixels.shape[0]
    cp = torch.zeros((n, 3), dtype=pixels.dtype, device=pixels.device)
    if coords is not None:
        w = (pixels - lo_mean[:, None]).clamp_min(0.0) * mask.to(torch.float32)
        wsum = w.sum(dim=1)
        c0 = (coords * w[..., None]).sum(dim=1) \
            / wsum.clamp_min(1e-12)[:, None]
        u = ((c0 - center_est) / delta[:, None]).clamp(-0.9, 0.9)
        cp = torch.where(wsum[:, None] > 1e-6, -2.0 * torch.atanh(u), 0.0)
    rest = torch.tensor([wg, wg, wg, 0.0, 0.0], dtype=torch.float32,
                        device=pixels.device).expand(n, 5)
    return torch.cat([bk[:, None], h[:, None], cp, rest], dim=1)


def _batched_lm(pixels, coords, mask, centers, delta_vec, min_w, max_w,
                init_w, lm_iters, params0):
    """Batch-fit N gathered blocks -> (params (N, 10), eps (N,))."""
    if params0 is None:
        params0 = init_params(pixels, mask, min_w, max_w, init_w,
                              coords=coords, center_est=centers,
                              delta=delta_vec)
    return lm_fit(pixels, coords, mask, centers, delta_vec, params0,
                  min_w, max_w, lm_iters=lm_iters)


def rebase_center_params(params: torch.Tensor, center_est: torch.Tensor,
                         old_delta: torch.Tensor,
                         new_delta: float) -> torch.Tensor:
    """Re-express the sigmoid-boxed centers under another delta box so a
    previous round's solution can warm-start the next round."""
    c = _to_center(params[:, 2:5], center_est, old_delta[:, None])
    u = ((c - center_est) / new_delta).clamp(-1 + 1e-6, 1 - 1e-6)
    out = params.clone()
    out[:, 2:5] = -2.0 * torch.atanh(u)
    return out


# ---------------------------------------------------------------------------
# Pixel-block gathering and neighbor bookkeeping
# ---------------------------------------------------------------------------


def ball_offsets(radius: int) -> np.ndarray:
    """(P, 3) integer offsets inside the fitting ball, with the reference's
    asymmetric range [-r, r) and |o| <= r filter (iter_fit :580-583)."""
    g = np.indices([2 * radius] * 3).reshape(3, -1).T - radius
    keep = (g ** 2).sum(1) <= radius ** 2
    return g[keep].astype(np.int32)


def gather_blocks(im: torch.Tensor, seeds_zxy: torch.Tensor, radius: int):
    """Gather (N, P) pixel blocks around integer seed positions.

    Returns (pixels, coords, base_mask), base_mask = in-ball & in-bounds
    (reference iter_fit :580-608).  Out-of-bounds pixels read a clamped
    voxel; they are masked out everywhere downstream.
    """
    dev = im.device
    offs = torch.as_tensor(ball_offsets(radius), device=dev)      # (P, 3)
    base = seeds_zxy.to(torch.int64)
    pos = base[:, None, :] + offs[None, :, :]                     # (N, P, 3)
    shape = torch.tensor(im.shape, device=dev)
    inb = ((pos >= 0) & (pos < shape)).all(dim=-1)
    pc = torch.minimum(pos.clamp_min(0), shape - 1)
    idx = (pc[..., 0] * im.shape[1] + pc[..., 1]) * im.shape[2] + pc[..., 2]
    pixels = im.to(torch.float32).reshape(-1)[idx]
    return pixels, pos.to(torch.float32), inb


def neighbor_lists(seeds_zxy: torch.Tensor, valid: torch.Tensor,
                   max_neighbors: int = 12, radius: int = 5):
    """For each seed, indices of up to K other valid seeds within 2r
    (reference iter_fit :612 rsearch=2r) -> (idx (N, K), nmask (N, K))."""
    n = seeds_zxy.shape[0]
    s = seeds_zxy.to(torch.float32)
    d2 = ((s[:, None] - s[None]) ** 2).sum(dim=-1)
    both = valid[:, None] & valid[None, :]
    inf = float("inf")
    d2 = torch.where(both, d2, inf)
    d2 = torch.where(torch.eye(n, dtype=torch.bool, device=s.device), inf, d2)
    within = d2 <= (2.0 * radius) ** 2
    neg = torch.where(within, -d2, -inf)
    vals, idx = torch.topk(neg, min(max_neighbors, n), dim=1)
    return idx, torch.isfinite(vals)


def ownership_mask(coords: torch.Tensor, seeds: torch.Tensor,
                   neighbor_seeds: torch.Tensor,
                   nmask: torch.Tensor) -> torch.Tensor:
    """Voronoi ownership (N, P): a pixel belongs to its seed iff no valid
    neighbor is strictly closer (reference closest_faster :422-424)."""
    d_own = ((coords - seeds[:, None].to(torch.float32)) ** 2).sum(dim=-1)
    d_nb = ((coords[:, :, None] - neighbor_seeds[:, None].to(torch.float32))
            ** 2).sum(dim=-1)                                     # (N, P, K)
    d_nb = torch.where(nmask[:, None, :], d_nb, float("inf"))
    return d_own <= d_nb.amin(dim=2)


def _recon_at(coords_k: torch.Tensor, nat_rows: torch.Tensor,
              which: torch.Tensor, wmask: torch.Tensor) -> torch.Tensor:
    """Sum of neighbors' peak reconstructions at each spot's pixels.

    coords_k (M, P, 3); nat_rows (N, 11); which/wmask (M, K)."""
    nb = nat_rows[which]                                          # (M, K, 11)
    h = nb[..., 0]
    s1 = 1.0 / (nb[..., 5] * nb[..., 5]).clamp_min(1e-6)
    s2 = 1.0 / (nb[..., 6] * nb[..., 6]).clamp_min(1e-6)
    s3 = 1.0 / (nb[..., 7] * nb[..., 7]).clamp_min(1e-6)
    a11, a22, a33, a12, a13, a23 = [
        a[..., None] for a in quadform_coeffs(nb[..., 8], nb[..., 9],
                                              s1, s2, s3)]
    d = coords_k[:, None, :, :] - nb[..., None, 1:4]              # (M, K, P, 3)
    q = (a11 * d[..., 0] ** 2 + a22 * d[..., 1] ** 2 + a33 * d[..., 2] ** 2
         + a12 * d[..., 0] * d[..., 1] + a13 * d[..., 0] * d[..., 2]
         + a23 * d[..., 1] * d[..., 2])
    val = h[..., None] * torch.exp(-0.5 * q)
    return torch.where(wmask[..., None], val, 0.0).sum(dim=1)


# ---------------------------------------------------------------------------
# Full iterative fitting pipeline
# ---------------------------------------------------------------------------


class FitResult(NamedTuple):
    spots: torch.Tensor        # (N, 11) natural-parameter rows
    valid: torch.Tensor        # (N,) bool
    converged: torch.Tensor    # (N,) bool -- center moved < tol in last round
    n_rounds: torch.Tensor     # () int32
    n_contested: torch.Tensor  # () int32 -- spots with >= 1 in-range neighbor


def iter_fit_seed_points(im: torch.Tensor, seeds_zxy: torch.Tensor,
                         seeds_valid: torch.Tensor,
                         radius: int = 5,
                         min_w: float = 0.5, max_w: float = 4.0,
                         init_w: float = 1.5,
                         min_delta_center: float = 1.0,
                         max_delta_center: float = 2.5,
                         lm_iters: int = 30,
                         n_max_iter: int = 10,
                         max_dist_th: float = 0.1,
                         max_neighbors: int = 12,
                         max_contested: Optional[int] = None) -> FitResult:
    """Fit all seeds concurrently with block-synchronous subtract-refit.

    Round 0 mirrors the reference `firstfit` on ownership-masked pixels:
    CONTESTED spots (>= 1 valid neighbor within 2r) keep the narrow
    firstfit center box (delta=min_delta_center), ISOLATED spots fit once
    in the wide box (delta=max_delta_center) and are final.  Rounds
    1..n_max_iter refit only the contested spots (full ball, neighbors'
    reconstructions subtracted, wide box), compacted into a prefix of
    capacity `max_contested` (default max(128, N/4) rounded up to 128;
    seeds arrive brightest-first, so an overflow freezes the dimmest).
    The round loop reads the convergence flags on the host once per round
    (one synchronisation per Jacobi round) to stop early as the JAX
    package's while_loop does.
    """
    dev = im.device
    f32 = torch.float32
    imf = im.to(f32)
    n = seeds_zxy.shape[0]
    seeds_valid = seeds_valid.to(torch.bool)
    pixels, coords, base_mask = gather_blocks(imf, seeds_zxy, radius)
    base_mask = base_mask & seeds_valid[:, None]
    nidx, nmask = neighbor_lists(seeds_zxy, seeds_valid,
                                 max_neighbors=max_neighbors, radius=radius)
    centers_est = seeds_zxy.to(f32)
    own = ownership_mask(coords, seeds_zxy, seeds_zxy[nidx], nmask)
    contested = nmask.any(dim=1) & seeds_valid
    n_contested = contested.to(torch.int32).sum()

    # ---- round 0: firstfit
    if n_max_iter >= 1:
        delta0 = torch.where(contested, min_delta_center,
                             max_delta_center).to(f32)
    else:
        delta0 = torch.full((n,), min_delta_center, dtype=f32, device=dev)
    params, eps = _batched_lm(pixels, coords, base_mask & own, centers_est,
                              delta0, min_w, max_w, init_w, lm_iters, None)
    nat = to_natural(params, centers_est, delta0, min_w, max_w, eps)

    # rebase contested round-0 params into the wider repeatfit box
    params = rebase_center_params(params, centers_est, delta0,
                                  max_delta_center)
    repeat_iters = max(8, lm_iters // 3)

    converged = ~contested if n_max_iter >= 1 else torch.zeros(
        n, dtype=torch.bool, device=dev)
    rounds_done = 0
    if max_contested is None:
        cap = min(n, max(128, -(-n // 4 // 128) * 128))
    else:
        cap = max(1, min(n, int(max_contested)))
    if n_max_iter >= 1 and cap > 0:
        order = torch.argsort((~contested).to(torch.int8), stable=True)
        sel_idx = order[:cap]
        iterating = torch.zeros(n, dtype=torch.bool, device=dev)
        iterating[sel_idx] = contested[sel_idx]
        pix_k = pixels[sel_idx]
        coords_k = coords[sel_idx]
        mask_k = base_mask[sel_idx]
        ce_k = centers_est[sel_idx]
        nidx_k = nidx[sel_idx]
        nmask_k = nmask[sel_idx]
        params_k = params[sel_idx]
        delta_k = torch.full((sel_idx.shape[0],), max_delta_center,
                             dtype=f32, device=dev)
        while (rounds_done < n_max_iter
               and not bool((converged | ~iterating).all())):
            sub_k = _recon_at(coords_k, nat, nidx_k, nmask_k)
            params_k, new_eps = _batched_lm(
                pix_k - sub_k, coords_k, mask_k, ce_k, delta_k, min_w,
                max_w, init_w, repeat_iters, params_k)
            new_nat = to_natural(params_k, ce_k, delta_k, min_w, max_w,
                                 new_eps)
            moved2 = ((new_nat[:, 1:4] - nat[sel_idx, 1:4]) ** 2).sum(dim=1)
            nat[sel_idx] = new_nat
            converged[sel_idx] = moved2 < max_dist_th ** 2
            rounds_done += 1

    # validity: seed valid, finite row, center strictly inside image
    finite = torch.isfinite(nat).all(dim=1)
    size = torch.tensor(imf.shape, dtype=f32, device=dev)
    inside = ((nat[:, 1:4] > 0) & (nat[:, 1:4] < size)).all(dim=1)
    enough_px = base_mask.to(torch.int32).sum(dim=1) > 10
    valid = seeds_valid & finite & inside & enough_px
    return FitResult(spots=nat, valid=valid, converged=converged,
                     n_rounds=torch.tensor(rounds_done, dtype=torch.int32,
                                           device=dev),
                     n_contested=n_contested)
