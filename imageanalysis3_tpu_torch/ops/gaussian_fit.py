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
blocks with bounds/ownership masks (ops/gather_kernel.py's ball entry), and
the LM engine is ops/lm_kernel.py (each the CUDA kernel for CUDA tensors,
its plain version on the CPU).  The sequential subtract-refit becomes
block-synchronous (Jacobi) rounds.  The entry points that take one image
(``fit_fov_image``, ``get_centers``) and the helpers of profile generation
(``select_sparse_centers``, ``find_image_background``, ``gfit_fast``)
follow the JAX module's lines 630-779.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import tracing
from ..device import as_tensor, device_constant
from .filters import counting_median
from .gather_kernel import ball_offsets, gather_ball
from .lm_kernel import (geometry_jacobian, lm_fit, lm_fit_plain,
                        quadform_coeffs, to_sine, to_ws)
from .matching import pairwise_distances
from .seeding import Seeds, get_seeds

__all__ = ["FitResult", "iter_fit_seed_points", "init_params",
           "gaussian_model", "to_natural", "lm_fit_single",
           "rebase_center_params",
           "ball_offsets", "gather_blocks", "neighbor_lists",
           "ownership_mask", "geometry_jacobian", "find_image_background",
           "fit_fov_image", "get_centers", "select_sparse_centers",
           "gfit_fast"]


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
    rest = device_constant(("fit_init_rest", wg), torch.float32,
                           pixels.device,
                           lambda: [wg, wg, wg, 0.0, 0.0]).expand(n, 5)
    return torch.cat([bk[:, None], h[:, None], cp, rest], dim=1)


LM_BACKENDS = ("auto", "xla", "pallas", "pallas_interpret")


def _lm_backend(lm_backend: str, device: torch.device) -> str:
    """The reference's ``lm_backend`` names: "auto" picks the kernel for a
    CUDA tensor and the plain LM elsewhere; "xla" is the plain LM on any
    device (with ``analytic_jac``); "pallas" the kernel, which needs a
    CUDA tensor; "pallas_interpret" the plain version of the kernel's
    arithmetic."""
    if lm_backend not in LM_BACKENDS:
        raise ValueError(f"lm_backend must be one of {LM_BACKENDS}, got "
                         f"{lm_backend!r}")
    if lm_backend == "auto":
        return "pallas" if device.type == "cuda" else "xla"
    if lm_backend == "pallas" and device.type != "cuda":
        raise ValueError("lm_backend 'pallas' runs the CUDA kernel: the "
                         f"image must be a CUDA tensor, got {device}")
    return lm_backend


def _batched_lm(pixels, coords, mask, centers, delta_vec, min_w, max_w,
                init_w, lm_iters, params0, analytic_jac, backend):
    """Batch-fit N gathered blocks -> (params (N, 10), eps (N,)) with the
    resolved `backend` (:func:`_lm_backend`): "pallas" the LM dispatcher
    (the kernel for a CUDA tensor), "xla" the plain LM with `analytic_jac`,
    "pallas_interpret" the plain LM with the kernel's Jacobian."""
    if params0 is None:
        params0 = init_params(pixels, mask, min_w, max_w, init_w,
                              coords=coords, center_est=centers,
                              delta=delta_vec)
    if backend == "pallas":
        return lm_fit(pixels, coords, mask, centers, delta_vec, params0,
                      min_w, max_w, lm_iters=lm_iters)
    return lm_fit_plain(pixels, coords, mask, centers, delta_vec, params0,
                        min_w, max_w, lm_iters=lm_iters,
                        analytic_jac=analytic_jac or backend != "xla")


def lm_fit_single(pixels, coords, mask, center_est, delta: float,
                  min_w: float, max_w: float, init_w: float,
                  lm_iters: int = 30, params0=None, analytic_jac: bool = True,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit one spot's pixel block (P,) -> (constrained params (10,), mean
    |residual|): a batch of one through the batched LM, so a CUDA tensor
    runs the ``lm_fit`` kernel (the CPU the plain LM with `analytic_jac`).
    NumPy inputs go to `device` (default the card).  For the JAX package's
    API; batches of spots belong in one call of the batched fit, not a
    loop over this."""
    px = as_tensor(pixels, device).to(torch.float32)
    dev = px.device
    as_row = lambda t, dt: torch.as_tensor(t, dtype=dt, device=dev)[None]
    backend = _lm_backend("auto", dev)
    delta_vec = torch.full((1,), float(delta), dtype=torch.float32,
                           device=dev)
    p0 = None if params0 is None else as_row(params0, torch.float32)
    params, eps = _batched_lm(px[None], as_row(coords, torch.float32),
                              as_row(mask, torch.bool),
                              as_row(center_est, torch.float32), delta_vec,
                              min_w, max_w, init_w, lm_iters, p0,
                              analytic_jac, backend)
    return params[0], eps[0]


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


def gather_blocks(im: torch.Tensor, seeds_zxy: torch.Tensor, radius: int):
    """Gather (N, P) pixel blocks around integer seed positions.

    Returns (pixels, coords, base_mask), base_mask = in-ball & in-bounds
    (reference iter_fit :580-608): :func:`gather_kernel.gather_ball`, which
    converts the seeds to int32 as XLA converts them and gathers the
    in-ball pixels as the JAX package's cube form does (each seed's (2r)^3
    cube, 2r clamped to the stack, its origin clipped into the stack, each
    offset clipped into its cube): on the card one kernel launch, the
    conversion included, with no cube array; on the CPU the cube-then-pack
    itself.  Every in-bounds ball pixel lies inside the cube; an
    out-of-bounds one reads a cube voxel, the same voxel as in the JAX
    package, and is masked out everywhere downstream.
    """
    return gather_ball(im, seeds_zxy, int(radius))


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
                         max_contested: Optional[int] = None,
                         analytic_jac: bool = True,
                         lm_backend: str = "auto") -> FitResult:
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
    package's while_loop does.  `lm_backend` and `analytic_jac` mean what
    they mean in the JAX package (:func:`_lm_backend`); ``analytic_jac=
    False`` takes J^T by forward-mode differentiation on the plain LM.
    """
    dev = im.device
    backend = _lm_backend(lm_backend, dev)
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
                              delta0, min_w, max_w, init_w, lm_iters, None,
                              analytic_jac, backend)
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
        while rounds_done < n_max_iter:
            with tracing.sync("refit_check"):
                done = bool((converged | ~iterating).all())
            if done:
                break
            with tracing.span("refit"):
                sub_k = _recon_at(coords_k, nat, nidx_k, nmask_k)
                params_k, new_eps = _batched_lm(
                    pix_k - sub_k, coords_k, mask_k, ce_k, delta_k, min_w,
                    max_w, init_w, repeat_iters, params_k, analytic_jac,
                    backend)
                new_nat = to_natural(params_k, ce_k, delta_k, min_w, max_w,
                                     new_eps)
                moved2 = ((new_nat[:, 1:4] - nat[sel_idx, 1:4]) ** 2
                          ).sum(dim=1)
                nat[sel_idx] = new_nat
                converged[sel_idx] = moved2 < max_dist_th ** 2
            rounds_done += 1

    # validity: seed valid, finite row, center strictly inside image
    finite = torch.isfinite(nat).all(dim=1)
    size = device_constant(("size",) + tuple(imf.shape), f32, dev,
                           lambda: list(imf.shape))
    inside = ((nat[:, 1:4] > 0) & (nat[:, 1:4] < size)).all(dim=1)
    enough_px = base_mask.to(torch.int32).sum(dim=1) > 10
    valid = seeds_valid & finite & inside & enough_px
    n_rounds = torch.full((), rounds_done, dtype=torch.int32, device=dev)
    return FitResult(spots=nat, valid=valid, converged=converged,
                     n_rounds=n_rounds, n_contested=n_contested)


# ---------------------------------------------------------------------------
# The fit's other entry points: one image in, fitted spots out
# ---------------------------------------------------------------------------


def find_image_background(im, bin_size: int = 10,
                          vmax: float = 65535.0) -> torch.Tensor:
    """Background level = centre of the histogram's dominant local peak
    (reference io_tools/load.py:642-687): `bin_size`-wide bins over the
    dtype range, the highest-count interior local maximum (ties to the
    lowest bin), the counting median when the histogram has none.
    NumPy input goes to the card unless `im` is a tensor."""
    imf = as_tensor(im).to(torch.float32)
    n_bins = int(vmax) // int(bin_size)
    idx = (imf / bin_size).to(torch.int32).clamp(0, n_bins - 1)
    cts = torch.bincount(idx.reshape(-1), minlength=n_bins).to(torch.int64)
    big = torch.iinfo(torch.int32).max
    left = torch.roll(cts, 1)
    left[0] = big
    right = torch.roll(cts, -1)
    right[-1] = big
    is_peak = (cts > left) & (cts >= right)
    best = torch.argmax(torch.where(is_peak, cts, -1))
    peak_val = (best.to(torch.float32) + 0.5) * bin_size
    return torch.where(is_peak.any(), peak_val, counting_median(imf))


def fit_fov_image(im, seeds: Optional[Seeds] = None,
                  max_num_seeds: int = 512, th_seed: float = 300.0,
                  radius: int = 5, lm_iters: int = 30, n_max_iter: int = 10,
                  normalize_background: bool = False, device=None,
                  **seed_kwargs) -> FitResult:
    """Seed + iteratively fit one image (reference spot_tools/fitting.py:
    169) -> fixed-capacity FitResult of 11-column rows [h, z, x, y, bk, wz,
    wx, wy, sin_t, sin_p, eps].  `seed_kwargs` go to ``get_seeds`` as in
    the JAX package; with `normalize_background` spot heights are divided
    by the image background (reference :240-247).  NumPy input goes to
    `device` (default the card); a tensor stays where it is."""
    im = as_tensor(im, device)
    if seeds is None:
        seeds = get_seeds(im, max_num_seeds=max_num_seeds, th_seed=th_seed,
                          **seed_kwargs)
    res = iter_fit_seed_points(im, seeds.coords.to(torch.float32),
                               seeds.valid, radius=radius,
                               lm_iters=lm_iters, n_max_iter=n_max_iter)
    if normalize_background:
        back = find_image_background(im).clamp_min(1e-6)
        spots = res.spots.clone()
        spots[:, 0] = spots[:, 0] / back
        res = res._replace(spots=spots)
    return res


def _dedupe_mask(centers: torch.Tensor, valid: torch.Tensor,
                 threshold: float) -> torch.Tensor:
    """Keep the first of any group of centres closer than `threshold`."""
    n = centers.shape[0]
    close = ((pairwise_distances(centers, centers) < threshold)
             & valid[:, None] & valid[None, :])
    ar = torch.arange(n, device=centers.device)
    earlier = ar[None, :] < ar[:, None]
    return ~(close & earlier).any(dim=1)


def get_centers(im, seeds: Optional[Seeds] = None, th_seed: float = 150.0,
                max_num_seeds: int = 512, radius: int = 5,
                remove_close_pts: bool = True, close_threshold: float = 0.1,
                device=None, **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fitted spot centres of one image -> ((N, 3) zxy, valid mask)
    (reference spot_tools/fitting.py:268-330): seed + fit, then drop
    near-duplicate centres within `close_threshold`."""
    res = fit_fov_image(im, seeds=seeds, max_num_seeds=max_num_seeds,
                        th_seed=th_seed, radius=radius, device=device,
                        **kwargs)
    centers = res.spots[:, 1:4]
    valid = res.valid
    if remove_close_pts:
        valid = valid & _dedupe_mask(centers, valid, close_threshold)
    return centers, valid


def select_sparse_centers(centers, valid,
                          distance_th: float = 25.0) -> torch.Tensor:
    """Greedy selection of mutually distant centres, first come first
    served (reference spot_tools/fitting.py:332-363): walk the centres in
    order, keep one iff it is valid and at least `distance_th` from every
    centre kept before it.  Returns the kept mask.

    The walk is a loop of small device operations over the precomputed
    (N, N) "too close" matrix, with no host synchronisation inside it."""
    centers = as_tensor(centers)
    valid = as_tensor(valid, centers.device).to(torch.bool)
    n = centers.shape[0]
    near = pairwise_distances(centers, centers) < distance_th
    near.fill_diagonal_(False)
    kept = torch.zeros(n, dtype=torch.bool, device=centers.device)
    for i in range(n):
        kept[i] = valid[i] & ~(kept & near[i]).any()
    return kept


def gfit_fast(pixels, coords, mask, bk_fraction: float = 0.1,
              reconstruct: bool = False) -> torch.Tensor:
    """Moment-based fast Gaussian fit of N pixel blocks (reference gfit_fast,
    External/Fitting_v4.py:433-490), batched over the blocks where the JAX
    package vmaps one: background = the `bk_fraction` quantile of the valid
    pixels, weights = clipped excess over it, position = weighted centroid,
    shape = weighted covariance.  `pixels` (N, P), `coords` (N, P, 3),
    `mask` (N, P) -> (N, 12) rows [h, z, x, y, bk, a, b, c, d, e, f, eps]
    (eps = mean |residual| with `reconstruct`, else NaN)."""
    pixels = as_tensor(pixels).to(torch.float32)
    coords = as_tensor(coords, pixels.device).to(torch.float32)
    mask = as_tensor(mask, pixels.device).to(torch.bool)
    maskf = mask.to(torch.float32)
    n = maskf.sum(dim=1).clamp_min(1.0)
    s = torch.sort(torch.where(mask, pixels, float("inf")), dim=1).values
    k = (n * bk_fraction).to(torch.int64).clamp(0, pixels.shape[1] - 1)
    bk = s.gather(1, k[:, None])[:, 0]
    w = (pixels - bk[:, None]).clamp_min(0.0) * maskf
    h = w.amax(dim=1)
    wn = w / w.sum(dim=1).clamp_min(1e-12)[:, None]
    zxy = (coords * wn[..., None]).sum(dim=1)
    d = coords - zxy[:, None, :]
    cov = torch.einsum("npi,npj,np->nij", d, d, wn)
    if reconstruct:
        eye = torch.eye(3, dtype=torch.float32, device=pixels.device)
        icov = torch.linalg.inv(cov + 1e-9 * eye)
        q = torch.einsum("npi,nij,npj->np", d, icov, d)
        fit = h[:, None] * torch.exp(-0.5 * q) + bk[:, None]
        eps = ((pixels - fit).abs() * maskf).sum(dim=1) / n
    else:
        eps = torch.full_like(h, float("nan"))
    return torch.stack([h, zxy[:, 0], zxy[:, 1], zxy[:, 2], bk,
                        cov[:, 0, 0], cov[:, 1, 1], cov[:, 2, 2],
                        cov[:, 0, 1], cov[:, 0, 2], cov[:, 1, 2], eps], dim=1)
