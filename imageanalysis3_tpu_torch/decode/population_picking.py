"""Population-reference spot picking: score every candidate against CDFs
pooled over the whole cell population, pick per-region maxima, iterate.

The counterpart of ``imageanalysis3_tpu/decode/population_picking.py``.
Behavior targets (reference spot_tools/picking.py, the "newer" picking
workflow): pick_spots_by_intensities (:1723-1749), chromosome_center_dists
(:1578-1656), local_center_dists (:1658-1720),
generate_reference_from_population (:1768-1876), cum_val (:1879-1899, as
the exact rank with the reference's two boundary conventions),
pick_spots_by_scores (:2017-2134), EM_pick_scores_in_population
(:2137-2279, its E+M step looped with a picked-set change-ratio stop),
evaluate_differences (:2280-2284) and screen_RNA_based_on_refs
(:2287-2316).  The JAX package's documented deviation holds here too:
with no explicit center, chromosome centers are the picked traces'.

The ragged per-chromosome lists become one dense (N, R, C, 4) hzxy tensor
(nm) with a validity mask.  Neighbour means are an (R, R) genomic-window
weight matrix applied as one full-float32 matrix product (the JAX
package's ``HIGHEST`` einsums), CDF lookups are sort + ``searchsorted``
over +inf-padded pooled rows, and the EM loop reads its stop condition
on the host once per iteration.  The entry points
(``pick_spots_by_intensities``, ``generate_reference_from_population``,
``pick_spots_by_scores``, ``em_pick_spots_in_population``) take
``device``: the CUDA card unless ``device="cpu"``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT_PIXEL_SIZE_NM
from ..device import as_tensor, resolve_device
from ..ops.filters import full_f32_matmul
from .scoring import norm, pixel_sizes, searchsorted


def spots_to_hzxys(spots: torch.Tensor,
                   pixel_size_nm=DEFAULT_PIXEL_SIZE_NM) -> torch.Tensor:
    """11-column spot rows -> hzxy rows in nm (reference :1738-1743)."""
    px = pixel_sizes(pixel_size_nm, spots.device)
    return torch.cat([spots[..., 0:1], spots[..., 1:4] * px], dim=-1)


def _pick(cand_hzxys, best, any_valid):
    """The (..., 4) rows at `best` along the candidate dim; NaN where a
    region has no valid candidate."""
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    sel = cand_hzxys.gather(-2, idx)[..., 0, :]
    return torch.where(any_valid[..., None], sel, float("nan"))


def pick_spots_by_intensities(cand_hzxys, cand_valid,
                              device=None) -> torch.Tensor:
    """Brightest valid candidate per region; NaN row where none.

    cand_hzxys: (..., C, 4); cand_valid: (..., C) -> (..., 4).
    Reference :1723-1749."""
    dev = resolve_device(device)
    cand_hzxys = as_tensor(cand_hzxys, dev).to(torch.float32)
    cand_valid = as_tensor(cand_valid, dev).to(torch.bool)
    h = torch.where(cand_valid, cand_hzxys[..., 0], float("-inf"))
    return _pick(cand_hzxys, h.argmax(dim=-1), cand_valid.any(dim=-1))


def _nan_rows(x: torch.Tensor) -> torch.Tensor:
    """Finite-row mask over the trailing hzxy axis."""
    return torch.isfinite(x).all(dim=-1)


def chromosome_center_dists(cand_hzxys: torch.Tensor,
                            cand_valid: torch.Tensor,
                            ref_center: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """(R, C) candidate distances to the chromosome center.

    ref_center: (3,) zxy in nm, or None -> mean over all valid finite
    candidates (reference :1578-1656 with ref_center=None).
    """
    zxy = cand_hzxys[..., 1:4]
    if ref_center is None:
        ok = (cand_valid & _nan_rows(cand_hzxys)).to(torch.float32)
        num = (zxy * ok[..., None]).sum(dim=(0, 1))
        ref_center = num / ok.sum().clamp_min(1.0)
    return norm(zxy - ref_center)


def local_center_dists(cand_hzxys: torch.Tensor, cand_valid: torch.Tensor,
                       cand_ids: torch.Tensor, ref_hzxys: torch.Tensor,
                       ref_ids: torch.Tensor, neighbor_len: int = 5,
                       channels: Optional[torch.Tensor] = None,
                       ref_channels: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """(..., R, C) candidate distances to the local picked-trace center.

    The local center of region id is the NaN-aware mean of ref rows whose
    genomic id lies within +-neighbor_len, the candidate's own id
    excluded; with `channels`, only same-channel refs count (reference
    local_center_dists :1658-1720, split_channels path).  Regions whose
    window holds no finite ref get NaN dists (no penalty downstream).
    cand_hzxys (..., R, C, 4) and ref_hzxys (..., Rr, 4) share leading
    batch dims (one per chromosome).
    """
    did = (cand_ids[:, None] - ref_ids[None, :]).abs()
    w = (did > 0) & (did <= neighbor_len)
    if channels is not None:
        if ref_channels is None:
            ref_channels = channels
        w = w & (channels[:, None] == ref_channels[None, :])
    w = w.to(torch.float32)                                 # (R, Rr)
    fin = _nan_rows(ref_hzxys).to(torch.float32)            # (..., Rr)
    ref0 = torch.where(torch.isfinite(ref_hzxys), ref_hzxys, 0.0)
    with full_f32_matmul():
        num = w @ (ref0 * fin[..., None])                   # (..., R, 4)
        den = (w @ fin[..., None])[..., 0]                  # (..., R)
    center = num / den.clamp_min(1.0)[..., None]
    center = torch.where((den > 0)[..., None], center, float("nan"))
    return norm(cand_hzxys[..., 1:4] - center[..., :, None, 1:4])


class PopulationReference(NamedTuple):
    """Sorted (+inf padded) pooled metric populations, one row per group.

    Row 0 pools every chromosome and region ('all'); with `channels`
    given at generation, row 1+c pools only channel-c regions
    (reference generate_reference_from_population :1838-1875)."""
    ints: torch.Tensor          # (G, K) ascending
    int_counts: torch.Tensor    # (G,) int32
    ct_dists: torch.Tensor      # (G, K)
    ct_counts: torch.Tensor     # (G,)
    local_dists: torch.Tensor   # (G, K)
    local_counts: torch.Tensor  # (G,)


def _pooled_rows(values: torch.Tensor, region_channels, n_channels: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, R) metric -> (G, N*R) sorted rows + (G,) finite counts."""
    flat = values.reshape(-1)
    fin = torch.isfinite(flat)
    rows = [torch.where(fin, flat, float("inf"))]
    if n_channels:
        ch_flat = region_channels[None, :].expand(values.shape).reshape(-1)
        for c in range(n_channels):
            rows.append(torch.where(fin & (ch_flat == c), flat,
                                    float("inf")))
    stacked = torch.stack(rows)
    counts = torch.isfinite(stacked).sum(dim=1).to(torch.int32)
    return torch.sort(stacked, dim=1).values, counts


def _trace_centers(hzxys: torch.Tensor) -> torch.Tensor:
    """(N, 3): mean of each (N, R, 4) trace's finite rows."""
    fin = _nan_rows(hzxys)
    num = torch.where(fin[..., None], hzxys[..., 1:4], 0.0).sum(dim=1)
    return num / fin.to(torch.float32).sum(dim=1).clamp_min(1.0)[:, None]


def generate_reference_from_population(
        picked_hzxys, picked_ids, ref_hzxys=None, ref_ids=None,
        ref_centers=None, neighbor_len: int = 7, channels=None,
        n_channels: int = 0, device=None) -> PopulationReference:
    """Pool picked-spot metrics over all chromosomes into sorted rows.

    picked_hzxys: (N, R, 4) current picks (NaN rows for empty regions);
    ref_hzxys: (N, R, 4) trace the local centers are measured against
    (defaults to the picks, reference :1785-1788); ref_centers: (N, 3)
    explicit chromosome centers (defaults to each trace's NaN-aware
    mean).  Reference generate_reference_from_population :1768-1876.
    """
    dev = resolve_device(device)
    picked = as_tensor(picked_hzxys, dev).to(torch.float32)
    picked_ids = as_tensor(picked_ids, dev)
    ref = picked if ref_hzxys is None else as_tensor(ref_hzxys, dev).to(
        torch.float32)
    ref_ids = picked_ids if ref_ids is None else as_tensor(ref_ids, dev)
    channels = None if channels is None else as_tensor(channels, dev)
    fin = _nan_rows(picked)                                 # (N, R)
    centers = (_trace_centers(picked) if ref_centers is None
               else as_tensor(ref_centers, dev).to(torch.float32))

    ct_dists = norm(picked[..., 1:4] - centers[:, None])   # (N, R)
    local_dists = local_center_dists(
        picked[..., None, :], torch.ones_like(fin)[..., None], picked_ids,
        ref, ref_ids, neighbor_len=neighbor_len, channels=channels)[..., 0]
    nan = float("nan")
    # NaN picks contribute nothing (matches the reference's isnan drop)
    ints = torch.where(fin, picked[..., 0], nan)
    ct_dists = torch.where(fin, ct_dists, nan)
    local_dists = torch.where(fin, local_dists, nan)
    return PopulationReference(
        *_pooled_rows(ints, channels, n_channels),
        *_pooled_rows(ct_dists, channels, n_channels),
        *_pooled_rows(local_dists, channels, n_channels))


def cum_val(sorted_vals: torch.Tensor, count: torch.Tensor,
            targets: torch.Tensor) -> torch.Tensor:
    """P(ref < target) over the first `count` entries of a sorted row.

    Exact-rank form of reference cum_val :1879-1899: rank clipped to
    [0.5, count-1], NaN targets rank 0.5 (no penalty); empty populations
    score neutral.
    """
    rank = searchsorted(sorted_vals, targets)
    rank = torch.where(torch.isnan(targets), 0, rank).to(torch.float32)
    cnt = count.to(torch.float32).clamp_min(1.0)
    p = torch.minimum(rank.clamp_min(0.5),
                      (cnt - 1.0).clamp_min(0.5)) / cnt
    return torch.where(count > 0, p, 0.5)


class PopulationPickResult(NamedTuple):
    sel_hzxys: torch.Tensor    # (N, R, 4) picked rows (NaN where none)
    sel_scores: torch.Tensor   # (N, R) picked log scores (NaN where none)
    sel_idx: torch.Tensor      # (N, R) candidate slot picked
    all_scores: torch.Tensor   # (N, R, C) per-candidate log scores (-inf
    #                            on invalid slots)


def _lookup(rows, counts, row_idx, targets):
    """cum_val of (N, R, C) targets against each region's row (`row_idx`
    (R,) into rows (G, K)), or against row 0 when `row_idx` is None."""
    if row_idx is None:
        return cum_val(rows[0], counts[0], targets)
    out = None
    for g in range(rows.shape[0]):
        p = cum_val(rows[g], counts[g], targets)
        out = p if out is None else torch.where(
            (row_idx == g)[:, None], p, out)
    return out


def pick_spots_by_scores(cand_hzxys, cand_valid, cand_ids, ref_hzxys,
                         reference: PopulationReference, ref_ids=None,
                         ref_centers=None, neighbor_len: int = 7,
                         center_weight: float = 1.0,
                         local_weight: float = 1.0, channels=None,
                         n_channels: int = 0,
                         split_intensity_channels: bool = False,
                         split_distance_channels: bool = False,
                         device=None) -> PopulationPickResult:
    """Score all candidates against the population CDFs, pick per-region
    maxima (reference pick_spots_by_scores :2017-2134 /
    _maximize_score_spot_picking_of_chr :1906-2013).

    cand_hzxys: (N, R, C, 4) in nm; ref_hzxys: (N, R, 4) current picks.
    Score = log p_int + center_weight*log(1-p_ct)
          + local_weight*log(1-p_lc); set a weight to 0 to drop a term
    (the reference's use_center/use_local switches).
    """
    dev = resolve_device(device)
    cand = as_tensor(cand_hzxys, dev).to(torch.float32)
    cand_valid = as_tensor(cand_valid, dev).to(torch.bool)
    cand_ids = as_tensor(cand_ids, dev)
    ref = as_tensor(ref_hzxys, dev).to(torch.float32)
    ref_ids = cand_ids if ref_ids is None else as_tensor(ref_ids, dev)
    channels = None if channels is None else as_tensor(channels, dev)
    centers = (_trace_centers(ref) if ref_centers is None
               else as_tensor(ref_centers, dev).to(torch.float32))

    ct_dists = norm(cand[..., 1:4] - centers[:, None, None])
    local_d = local_center_dists(
        cand, cand_valid, cand_ids, ref, ref_ids, neighbor_len=neighbor_len,
        channels=channels if split_distance_channels else None)

    # group row per region: 0 = 'all', 1+c = channel c
    r = cand.shape[1]
    if n_channels and channels is not None:
        ch_row = channels.to(torch.int64) + 1
    else:
        ch_row = torch.zeros(r, dtype=torch.int64, device=cand.device)
    int_row = ch_row if split_intensity_channels else None
    dist_row = ch_row if split_distance_channels else None

    score = torch.log(_lookup(reference.ints, reference.int_counts, int_row,
                              cand[..., 0]))
    if center_weight != 0.0:
        p_ct = _lookup(reference.ct_dists, reference.ct_counts, dist_row,
                       ct_dists)
        score = score + center_weight * torch.log1p(-p_ct)
    if local_weight != 0.0:
        p_lc = _lookup(reference.local_dists, reference.local_counts,
                       dist_row, local_d)
        score = score + local_weight * torch.log1p(-p_lc)

    score = torch.where(cand_valid, score, float("-inf"))
    best = score.argmax(dim=-1)                             # (N, R)
    any_valid = cand_valid.any(dim=-1)
    sel_sc = torch.where(any_valid, score.gather(-1, best[..., None])[..., 0],
                         float("nan"))
    return PopulationPickResult(_pick(cand, best, any_valid), sel_sc, best,
                                score)


class PopulationEMResult(NamedTuple):
    sel_hzxys: torch.Tensor   # (N, R, 4)
    sel_scores: torch.Tensor  # (N, R)
    sel_idx: torch.Tensor     # (N, R)
    n_iters: torch.Tensor     # () int32 E+M rounds run
    change_ratio: torch.Tensor  # () fraction of picks changed in the last M


def em_pick_spots_in_population(cand_hzxys, cand_valid, cand_ids,
                                init_hzxys=None, neighbor_len: int = 5,
                                center_weight: float = 1.0,
                                local_weight: float = 1.0, channels=None,
                                n_channels: int = 0,
                                split_intensity_channels: bool = False,
                                split_distance_channels: bool = False,
                                max_niter: int = 10,
                                change_th: float = 0.005,
                                device=None) -> PopulationEMResult:
    """EM loop over population-reference picking (reference
    EM_pick_scores_in_population :2137-2279, which exposes one E+M step
    that notebooks iterate; the loop and its picked-set change-ratio stop
    run here, with one host read per iteration).

    E: regenerate the pooled CDF references from the current picks;
    M: re-pick every region by score.  Stops when the fraction of
    regions whose picked candidate changed drops below `change_th`.
    """
    dev = resolve_device(device)
    cand = as_tensor(cand_hzxys, dev).to(torch.float32)
    cand_valid = as_tensor(cand_valid, dev).to(torch.bool)
    cand_ids = as_tensor(cand_ids, dev)
    channels = None if channels is None else as_tensor(channels, dev)
    dev = cand.device
    picked = (pick_spots_by_intensities(cand, cand_valid, device=dev)
              if init_hzxys is None
              else as_tensor(init_hzxys, dev).to(torch.float32))
    any_valid = cand_valid.any(dim=-1)
    n_filled = np.float32(max(int(any_valid.sum()), 1))
    idx = torch.where(cand_valid, cand[..., 0], float("-inf")).argmax(dim=-1)
    pick_kw = dict(neighbor_len=neighbor_len, center_weight=center_weight,
                   local_weight=local_weight, channels=channels,
                   n_channels=n_channels,
                   split_intensity_channels=split_intensity_channels,
                   split_distance_channels=split_distance_channels,
                   device=dev)

    def e_and_m(picked):
        ref = generate_reference_from_population(
            picked, cand_ids, neighbor_len=neighbor_len, channels=channels,
            n_channels=n_channels, device=dev)
        return pick_spots_by_scores(cand, cand_valid, cand_ids, picked, ref,
                                    **pick_kw)

    n_it, change = 0, np.float32(np.inf)
    while n_it < max_niter and change > np.float32(change_th):
        res = e_and_m(picked)
        changed = int(((res.sel_idx != idx) & any_valid).sum())
        change = np.float32(changed) / n_filled
        n_it, picked, idx = n_it + 1, res.sel_hzxys, res.sel_idx
    # final scores for the converged picks
    score = e_and_m(picked).all_scores.gather(-1, idx[..., None])[..., 0]
    return PopulationEMResult(
        picked, torch.where(any_valid, score, float("nan")), idx,
        torch.tensor(n_it, dtype=torch.int32, device=dev),
        torch.tensor(float(change), dtype=torch.float32, device=dev))


def evaluate_differences(old_hzxys: torch.Tensor,
                         new_hzxys: torch.Tensor) -> torch.Tensor:
    """Fraction of picked positions that moved < 0.01 nm between two pick
    sets, over positions finite in both (reference evaluate_differences,
    picking.py:2280-2284)."""
    d = norm(old_hzxys[..., 1:4] - new_hzxys[..., 1:4])
    fin = torch.isfinite(d)
    n = fin.to(torch.float32).sum().clamp_min(1.0)
    return ((d < 0.01) & fin).to(torch.float32).sum() / n


def screen_rna_based_on_refs(cand_hzxys: torch.Tensor,
                             cand_valid: torch.Tensor,
                             cand_to_ref: torch.Tensor,
                             ref_hzxys: torch.Tensor,
                             dist_th: float = 500.0,
                             keep_no_ref: bool = False) -> torch.Tensor:
    """Keep RNA candidates within `dist_th` nm of their DNA reference.

    cand_hzxys: (R', C, 4); cand_to_ref: (R',) index of each RNA region's
    reference row in ref_hzxys (R, 4).  Regions whose reference is NaN
    keep everything (keep_no_ref=True) or nothing (False).  Returns the
    screened validity mask (reference screen_RNA_based_on_refs,
    picking.py:2287-2316).
    """
    ref = ref_hzxys[cand_to_ref]                            # (R', 4)
    ref_ok = torch.isfinite(ref[:, 1:4]).all(dim=-1)
    d = norm(cand_hzxys[..., 1:4] - ref[:, None, 1:4])
    near = cand_valid & (d <= dist_th)
    return torch.where(ref_ok[:, None], near,
                       cand_valid if keep_no_ref else False)
