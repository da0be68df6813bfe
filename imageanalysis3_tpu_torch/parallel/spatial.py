"""Spatial sharding of one FOV across the ranks of a mesh.

The counterpart of ``imageanalysis3_tpu/parallel/spatial.py``.  The
reference has no intra-image parallelism -- crops are sequential slices on
one process.  Here one (Z, X, Y) stack is split along x over the ranks of a
1-D "data" mesh (one card each, or gloo processes on the CPU) and processed
with real collectives:

  * halo exchange with the two ring neighbours (``batch_isend_irecv``)
    feeds each rank the neighbour columns its stencils need (filters,
    hot-pixel neighbourhoods); the image-border ranks reflect their own
    edge columns;
  * global statistics ride ``all_reduce`` (counting-median layer stats,
    dynamic-threshold seed histograms, drift tables, fit pixel blocks);
  * seed extraction is local top-k + ``all_gather`` + global top-k, and the
    fit's natural-parameter table is rebuilt by ``all_gather`` every
    Jacobi round.

Every function takes the full stack on every rank or a DTensor sharded
along x, and returns the global result on every rank.  A mesh of one rank
gives the unsharded result: both halos are reflections and every
collective is the identity.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from ..ops.drift import (consensus_drift, generate_drift_crops,
                         subpixel_phase_correlation)
from ..ops.gaussian_fit import (_batched_lm, _lm_backend, _recon_at,
                                ball_offsets, neighbor_lists, ownership_mask,
                                rebase_center_params, to_natural)
from ..ops.seeding import Seeds, _level_diff_hist, _radius
from .mesh import gather_cat, mesh_device


def halo_exchange(x: torch.Tensor, halo: int, mesh: DeviceMesh,
                  axis: int = 1, axis_name: str = "data") -> torch.Tensor:
    """Pad the sharded `axis` of this rank's block with `halo` columns from
    its ring neighbours.

    Non-periodic: the first and last rank pad their outer side with the
    symmetric reflection of their own edge columns (the single-device
    path's mode="symmetric" padding), so a one-rank mesh returns the
    symmetric pad of `x`."""
    if halo == 0:
        return x
    group = mesh.get_group(axis_name)
    rank, n = mesh.get_local_rank(axis_name), mesh.size()
    size = x.shape[axis]
    lo = x.narrow(axis, 0, halo).contiguous()
    hi = x.narrow(axis, size - halo, halo).contiguous()
    from_left = lo.flip(axis) if rank == 0 else torch.empty_like(hi)
    from_right = hi.flip(axis) if rank == n - 1 else torch.empty_like(lo)
    ops = []
    if rank > 0:
        peer = dist.get_global_rank(group, rank - 1)
        ops += [dist.P2POp(dist.isend, lo, peer, group),
                dist.P2POp(dist.irecv, from_left, peer, group)]
    if rank < n - 1:
        peer = dist.get_global_rank(group, rank + 1)
        ops += [dist.P2POp(dist.isend, hi, peer, group),
                dist.P2POp(dist.irecv, from_right, peer, group)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return torch.cat([from_left, x, from_right], dim=axis)


def _psum_counting_median(imf: torch.Tensor, mesh: DeviceMesh,
                          axis=(1, 2), bits: int = 18,
                          axis_name: str = "data") -> torch.Tensor:
    """Per-z-layer median over the global (sharded) x-y plane, or the
    global median with ``axis=(0, 1, 2)``: the counting binary search of
    ``ops.filters.counting_median``, each step's counts summed over the
    ranks by ``all_reduce``."""
    group = mesh.get_group(axis_name)
    scale = 4.0
    codes = torch.floor(imf * scale + 0.5).to(torch.int32)
    n = mesh.size()
    for ax in axis:
        n *= imf.shape[ax]
    half = (n + 1) // 2
    red_shape = [s for i, s in enumerate(imf.shape) if i not in axis]
    lo = torch.zeros(red_shape, dtype=torch.int32, device=imf.device)
    hi = lo + ((1 << bits) - 1)
    for _ in range(bits):
        mid = (lo + hi) >> 1
        mid_b = mid
        for ax in sorted(axis):
            mid_b = mid_b.unsqueeze(ax)
        cnt = (codes <= mid_b).sum(dim=axis, dtype=torch.int32).reshape(-1)
        dist.all_reduce(cnt, group=group)
        ok = cnt.reshape(red_shape) >= half
        lo, hi = torch.where(ok, lo, mid + 1), torch.where(ok, mid, hi)
    return lo.to(torch.float32) / scale


def _local_x_block(t, mesh: DeviceMesh, x_dim: int) -> Tuple[torch.Tensor,
                                                              Tuple[int, ...]]:
    """This rank's x-block of `t` on the mesh's device and the global
    shape: `t` is the full array (every rank passes the same) or a DTensor
    sharded along `x_dim`."""
    if isinstance(t, DTensor):
        if tuple(t.placements) != (Shard(x_dim),):
            raise ValueError(f"expected a DTensor sharded along dim "
                             f"{x_dim}, got {t.placements}")
        return t.to_local(), tuple(t.shape)
    full = torch.as_tensor(t, device=mesh_device(mesh))
    n = mesh.size()
    x = full.shape[x_dim]
    if x % n:
        raise ValueError(f"x={x} must divide over {n} ranks")
    w = x // n
    return full.narrow(x_dim, mesh.get_local_rank() * w, w), \
        tuple(full.shape)


def _f32(a, dev) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dev, torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


def _correct_local(imf: torch.Tensor, mesh: DeviceMesh, x0: int,
                   full_x: int, prof: Optional[torch.Tensor],
                   hot_pixel: bool, hot_pixel_th: float,
                   hot_pixel_ratio: float, z_shift: bool) -> torch.Tensor:
    """Hot pixels (1-px halo), z-shift from the global layer medians,
    flat-field and clip on this rank's (Z, shard_x, Y) block, in the
    arithmetic of ``ops.corrections.correct_channel_stack``."""
    _, shard_x, y = imf.shape
    if hot_pixel:
        padded = halo_exchange(imf, 1, mesh)
        up = padded[:, :-2, :]
        down = padded[:, 2:, :]
        left = torch.roll(imf, 1, 2)
        right = torch.roll(imf, -1, 2)
        neigh = (up + down + left + right) * 0.25
        hot_frac = (imf > hot_pixel_ratio * neigh).to(torch.float32
                                                      ).mean(dim=0)
        hot2d = hot_frac > hot_pixel_th
        gxi = x0 + torch.arange(shard_x, device=imf.device)[:, None]
        gyi = torch.arange(y, device=imf.device)[None, :]
        interior = (gxi > 0) & (gxi < full_x - 1) & (gyi > 0) & (gyi < y - 1)
        imf = torch.where((hot2d & interior)[None], neigh, imf)
    if z_shift:
        layer_med = _psum_counting_median(imf, mesh)
        global_med = _psum_counting_median(imf, mesh, axis=(0, 1, 2))
        imf = imf / layer_med[:, None, None] * global_med
    if prof is not None:
        imf = imf / prof[None].to(torch.float32)
    return imf.clamp(0.0, 65535.0)


def _seed_halo(gfilt_size, background_gfilt_size, filt_size) -> int:
    return max(_radius(gfilt_size), _radius(background_gfilt_size)) \
        + (filt_size // 2)


def _sharded_seeds(qdiff: torch.Tensor, hist: torch.Tensor, th_seed,
                   n_lvl: int, min_dynamic_seeds: int, max_num_seeds: int,
                   x0: int, full_shape, mesh: DeviceMesh) -> Seeds:
    """Dynamic-threshold selection on the all-reduced level histogram, the
    hot-column screen, then local top-k, ``all_gather`` and the global
    top-k -> the global seed table."""
    group = mesh.get_group()
    dev = qdiff.device
    z, x, y = full_shape
    counts = hist.to(torch.int64).clone()
    dist.all_reduce(counts, group=group)
    reach = torch.cumsum(counts, dim=0) >= min_dynamic_seeds
    chosen = torch.where(reach.any(), reach.to(torch.int32).argmax(),
                         n_lvl - 1)
    th = torch.tensor(float(max(np.float32(th_seed), np.float32(1e-6))),
                      dtype=torch.float32, device=dev)
    chosen_f = chosen.to(torch.float32)
    chosen_th = th * (1.0 - chosen_f / n_lvl)
    # level(q) <= chosen with the classification's exact arithmetic
    # (q = -inf maps to level +inf -> excluded)
    sel = torch.ceil((1.0 - qdiff / th) * n_lvl) <= chosen_f
    xy_counts = sel.to(torch.int32).sum(dim=0)
    sel = sel & (xy_counts[None] < 3)
    n_sel = sel.sum(dtype=torch.int64).reshape(1)
    dist.all_reduce(n_sel, group=group)

    masked = torch.where(sel, qdiff, float("-inf")).reshape(-1)
    v1, i1 = torch.topk(masked, min(max_num_seeds, masked.numel()))
    shard_x = qdiff.shape[1]
    zc = i1 // (shard_x * y)
    rem = i1 % (shard_x * y)
    flat_global = (zc * x + (rem // y + x0)) * y + rem % y
    v_all = gather_cat(v1, mesh)
    f_all = gather_cat(flat_global, mesh)
    hts, order = torch.topk(v_all, max_num_seeds)
    fidx = f_all[order]
    coords = torch.stack([fidx // (x * y), fidx % (x * y) // y,
                          fidx % y], dim=1)
    valid = torch.isfinite(hts)
    return Seeds(coords=torch.where(valid[:, None], coords, -1
                                    ).to(torch.int32),
                 heights=torch.where(valid, hts, 0.0), valid=valid,
                 count=n_sel[0].clamp_max(max_num_seeds).to(torch.int32),
                 threshold=chosen_th, saturated=n_sel[0] > max_num_seeds)


def sharded_correct_and_seed(im, mesh: DeviceMesh, illumination=None,
                             hot_pixel: bool = True,
                             hot_pixel_th: float = 0.5,
                             hot_pixel_ratio: float = 4.0,
                             z_shift: bool = True,
                             th_seed: float = 300.0,
                             max_num_seeds: int = 1024,
                             dynamic_niters: int = 10,
                             min_dynamic_seeds: int = 1,
                             gfilt_size: float = 0.75,
                             background_gfilt_size: float = 7.5,
                             filt_size: int = 3,
                             min_edge_distance: int = 2,
                             axis_name: str = "data"
                             ) -> Tuple[torch.Tensor, Seeds]:
    """Correct one (Z, X, Y) stack and seed it, x-sharded over `mesh`.

    Hot-pixel removal (1-px halo), z-shift normalization (all-reduced
    global layer medians), illumination flat-field, the seeding level pass
    (``ops.seeding._level_diff_hist`` on the filter-radius halo tile), the
    all-reduced dynamic-threshold histogram and the all-gathered global
    top-k seed selection.  Returns the corrected (Z, X, Y) stack and the
    seed table, both global, on every rank.
    """
    if mesh.mesh_dim_names != (axis_name,):
        raise ValueError(f"mesh dims {mesh.mesh_dim_names}")
    local, (z, x, y) = _local_x_block(im, mesh, 1)
    shard_x = local.shape[1]
    x0 = mesh.get_local_rank() * shard_x
    halo = _seed_halo(gfilt_size, background_gfilt_size, filt_size)
    if halo > shard_x:
        raise ValueError("halo exceeds the shard width; use fewer ranks")
    prof = (None if illumination is None
            else _f32(illumination, local.device)[x0:x0 + shard_x])
    imf = _correct_local(local.to(torch.float32), mesh, x0, x, prof,
                         hot_pixel, hot_pixel_th, hot_pixel_ratio, z_shift)
    tile = halo_exchange(imf, halo, mesh)
    qdiff, hist = _level_diff_hist(
        tile, th_seed, x0, shard_x, (z, x, y), gfilt_size,
        background_gfilt_size, filt_size, min_edge_distance, dynamic_niters)
    seeds = _sharded_seeds(qdiff, hist, th_seed, dynamic_niters,
                           min_dynamic_seeds, max_num_seeds, x0, (z, x, y),
                           mesh)
    return gather_cat(imf, mesh, dim=1), seeds


# ---------------------------------------------------------------------------
# Full sharded round: correct -> drift -> seed -> fit
# ---------------------------------------------------------------------------


def _sharded_fit(imf_local: torch.Tensor, x0: int, mesh: DeviceMesh,
                 seeds_zxy: torch.Tensor, seeds_valid: torch.Tensor,
                 radius: int, min_w: float, max_w: float, init_w: float,
                 min_delta_center: float, max_delta_center: float,
                 lm_iters: int, n_max_iter: int, max_dist_th: float,
                 max_neighbors: int):
    """Batched LM fit of globally known seeds on an x-sharded stack.

    Pixel blocks assemble by core ownership: every rank gathers the ball
    pixels whose global x lies in its own core and ``all_reduce`` sums the
    disjoint contributions (blocks are (N, |ball|) f32 -- a few MB, never
    the image).  The LM work shards over spots: each rank fits N / ranks
    seeds in one batched LM call (the ``lm_fit`` kernel on a card) per
    round, and ``all_gather`` rebuilds the (N, 11) table every Jacobi
    subtract-refit round, which refits every spot until every valid one
    moved less than `max_dist_th` or `n_max_iter` rounds ran (the JAX
    package's stop rule, read on the host once a round).
    """
    group = mesh.get_group()
    rank, n_ranks = mesh.get_local_rank(), mesh.size()
    z, shard_x, y = imf_local.shape
    n = seeds_zxy.shape[0]
    if n % n_ranks:
        raise ValueError("the seed capacity must divide over the ranks")
    chunk = n // n_ranks
    rows = slice(rank * chunk, (rank + 1) * chunk)
    dev = imf_local.device
    f32 = torch.float32

    offs = torch.as_tensor(ball_offsets(radius), device=dev)     # (P, 3)
    pos = seeds_zxy.to(torch.int32)[:, None, :] + offs[None]      # (N, P, 3)
    shape_g = torch.tensor([z, shard_x * n_ranks, y], dtype=torch.int32,
                           device=dev)
    inb = ((pos >= 0) & (pos < shape_g)).all(dim=-1)
    owned = (pos[..., 1] >= x0) & (pos[..., 1] < x0 + shard_x)
    lx = (pos[..., 1] - x0).clamp(0, shard_x - 1).to(torch.int64)
    lz = pos[..., 0].clamp(0, z - 1).to(torch.int64)
    ly = pos[..., 2].clamp(0, y - 1).to(torch.int64)
    contrib = imf_local.reshape(-1)[(lz * shard_x + lx) * y + ly]
    pixels = torch.where(owned & inb, contrib, 0.0)
    dist.all_reduce(pixels, group=group)                          # (N, P)
    coords = pos.to(f32)
    base_mask = inb & seeds_valid[:, None]

    nidx, nmask = neighbor_lists(seeds_zxy, seeds_valid,
                                 max_neighbors=max_neighbors, radius=radius)
    centers_est = seeds_zxy.to(f32)
    own = ownership_mask(coords, seeds_zxy, seeds_zxy[nidx], nmask)
    backend = _lm_backend("auto", dev)
    ce = centers_est[rows]

    # round 0: firstfit on the local spot chunk, narrow centre box
    delta0 = torch.full((chunk,), min_delta_center, dtype=f32, device=dev)
    p_loc, e_loc = _batched_lm(pixels[rows], coords[rows],
                               (base_mask & own)[rows], ce, delta0, min_w,
                               max_w, init_w, lm_iters, None, True, backend)
    nat = gather_cat(to_natural(p_loc, ce, delta0, min_w, max_w, e_loc),
                     mesh)
    p_loc = rebase_center_params(p_loc, ce, delta0, max_delta_center)
    repeat_iters = max(8, lm_iters // 3)
    delta = torch.full((chunk,), max_delta_center, dtype=f32, device=dev)

    converged = torch.zeros(n, dtype=torch.bool, device=dev)
    i = 0
    while i < n_max_iter and not bool((converged | ~seeds_valid).all()):
        sub = _recon_at(coords[rows], nat, nidx[rows], nmask[rows])
        p_loc, e_loc = _batched_lm(pixels[rows] - sub, coords[rows],
                                   base_mask[rows], ce, delta, min_w, max_w,
                                   init_w, repeat_iters, p_loc, True,
                                   backend)
        new_nat = gather_cat(to_natural(p_loc, ce, delta, min_w, max_w,
                                        e_loc), mesh)
        converged = ((new_nat[:, 1:4] - nat[:, 1:4]) ** 2).sum(dim=1) \
            < max_dist_th ** 2
        nat = new_nat
        i += 1

    finite = torch.isfinite(nat).all(dim=1)
    inside = ((nat[:, 1:4] > 0) & (nat[:, 1:4] < shape_g.to(f32))).all(dim=1)
    enough = base_mask.to(torch.int32).sum(dim=1) > 10
    return nat, seeds_valid & finite & inside & enough


def _drift_crop_plan(image_shape, shard_x: int, n_shards: int,
                     drift_size: Optional[int]):
    """Host-side static plan: crop boxes, per-rank crop assignment (the
    rank whose core holds the crop's first x), and the right-halo width
    letting each owner slice its crops locally."""
    boxes = generate_drift_crops(image_shape, drift_size)
    per_shard: List[list] = [[] for _ in range(n_shards)]
    halo = 0
    for k, b in enumerate(boxes):
        lo_x, hi_x = int(b[1][0]), int(b[1][1])
        owner = min(lo_x // shard_x, n_shards - 1)
        halo = max(halo, hi_x - (owner + 1) * shard_x, 0)
        per_shard[owner].append((k, b))
    return boxes, per_shard, halo


def sharded_process_round(ims, ref_im, mesh: DeviceMesh,
                          drift_channel_index: int,
                          fit_channel_indices: Sequence[int],
                          seed_thresholds,
                          illumination=None,
                          hot_pixel: bool = True,
                          hot_pixel_th: float = 0.5,
                          hot_pixel_ratio: float = 4.0,
                          z_shift: bool = True,
                          drift_size: Optional[int] = None,
                          upsample_factor: int = 100,
                          good_drift_th: float = 1.0,
                          min_good_drifts: int = 3,
                          drift_subtract_mean: bool = True,
                          drift_window: Optional[str] = "hann_xy",
                          max_num_seeds: int = 512,
                          dynamic_niters: int = 10,
                          min_dynamic_seeds: int = 1,
                          gfilt_size: float = 0.75,
                          background_gfilt_size: float = 7.5,
                          filt_size: int = 3,
                          min_edge_distance: int = 2,
                          radius: int = 5,
                          min_w: float = 0.5, max_w: float = 4.0,
                          init_w: float = 1.5,
                          min_delta_center: float = 1.0,
                          max_delta_center: float = 2.5,
                          lm_iters: int = 30, n_max_iter: int = 10,
                          max_dist_th: float = 0.1,
                          max_neighbors: int = 12,
                          axis_name: str = "data"):
    """One hybridization round, x-sharded across the whole mesh.

    The sharded counterpart of ``FovPipeline.process_round``: corrections
    (halo exchange + all-reduced medians), the 8-crop drift consensus (each
    crop registered by the rank owning its first x column, through a static
    crop plan, the drift table all-reduced), dynamic-threshold seeding
    (all-reduced histogram + all-gathered top-k) and spot-sharded LM
    fitting (`_sharded_fit`).  `ims` is (C, Z, X, Y) (full, or a DTensor
    sharded along x, dim 2), `ref_im` (Z, X, Y) (full, or sharded along
    dim 1).  Returns (corrected (C, Z, X, Y), spots (F, N, 11), valid (F,
    N), drift (3,), drift_flag) on every rank; spot coordinates are
    drift-corrected (chromatic terms are applied downstream).
    """
    if mesh.mesh_dim_names != (axis_name,):
        raise ValueError(f"mesh dims {mesh.mesh_dim_names}")
    rank, n_ranks = mesh.get_local_rank(), mesh.size()
    local, (c, z, x, y) = _local_x_block(ims, mesh, 2)
    ref_local, _ = _local_x_block(ref_im, mesh, 1)
    shard_x = local.shape[2]
    x0 = rank * shard_x
    fit_idx = tuple(int(i) for i in fit_channel_indices)
    th = [float(np.float32(t)) for t in np.asarray(seed_thresholds).ravel()]
    if max_num_seeds % n_ranks:
        raise ValueError("max_num_seeds must divide over the mesh")
    boxes, per_shard, drift_halo = _drift_crop_plan(
        (z, x, y), shard_x, n_ranks, drift_size)
    halo = max(_seed_halo(gfilt_size, background_gfilt_size, filt_size),
               drift_halo, 1)
    if halo > shard_x:
        raise ValueError("halo exceeds the shard width; use fewer ranks")
    dev = local.device
    prof = (None if illumination is None
            else _f32(illumination, dev)[:, x0:x0 + shard_x])
    corrected = torch.stack([
        _correct_local(local[ci].to(torch.float32), mesh, x0, x,
                       None if prof is None else prof[ci], hot_pixel,
                       hot_pixel_th, hot_pixel_ratio, z_shift)
        for ci in range(c)])

    # ---- drift: each rank registers its own crops from halo tiles
    src_tile = halo_exchange(corrected[drift_channel_index], halo, mesh)
    ref_tile = halo_exchange(ref_local.to(torch.float32), halo, mesh)
    table = torch.zeros((len(boxes), 3), dtype=torch.float32, device=dev)
    got = torch.zeros((len(boxes),), dtype=torch.float32, device=dev)
    mine = per_shard[rank]
    if mine:
        def crops(tile):
            return torch.stack([tile[int(b[0][0]):int(b[0][1]),
                                     int(b[1][0]) - x0 + halo:
                                     int(b[1][1]) - x0 + halo,
                                     int(b[2][0]):int(b[2][1])]
                                for _, b in mine])
        ks = torch.tensor([k for k, _ in mine], device=dev)
        table[ks] = subpixel_phase_correlation(
            crops(ref_tile), crops(src_tile),
            upsample_factor=upsample_factor,
            subtract_mean=drift_subtract_mean, window=drift_window)
        got[ks] = 1.0
    del src_tile, ref_tile
    group = mesh.get_group()
    dist.all_reduce(table, group=group)
    dist.all_reduce(got, group=group)
    drift, dflag = consensus_drift(
        torch.where(got[:, None] > 0, table, float("inf")),
        drift_diff_th=good_drift_th, min_good_drifts=min_good_drifts)

    # ---- seed + fit each fit channel
    spots_list, valid_list = [], []
    for ci in fit_idx:
        imf = corrected[ci]
        qdiff, hist = _level_diff_hist(
            halo_exchange(imf, halo, mesh), th[ci], x0, shard_x, (z, x, y),
            gfilt_size, background_gfilt_size, filt_size, min_edge_distance,
            dynamic_niters)
        seeds = _sharded_seeds(qdiff, hist, th[ci], dynamic_niters,
                               min_dynamic_seeds, max_num_seeds, x0,
                               (z, x, y), mesh)
        del qdiff
        nat, f_valid = _sharded_fit(
            imf, x0, mesh, seeds.coords.to(torch.float32), seeds.valid,
            radius, min_w, max_w, init_w, min_delta_center,
            max_delta_center, lm_iters, n_max_iter, max_dist_th,
            max_neighbors)
        nat[:, 1:4] += drift[None]
        spots_list.append(nat)
        valid_list.append(f_valid)

    return (gather_cat(corrected, mesh, dim=2), torch.stack(spots_list),
            torch.stack(valid_list), drift, dflag)
