"""Spot scoring against a chromosome's selected trace.

The counterpart of ``imageanalysis3_tpu/decode/scoring.py``.  Behavior
targets (reference spot_tools/scoring.py): the linear distance and
intensity scores (:6-79), the windowed weak CDF ``_cum_prob`` (:81-107),
center / local / neighbouring distances (:111-205), the reference
statistics of a selected trace (:217-305), the combined E-step score
(:306-410) and the 4-metric CDF variant (:423-518), and the utilities
(:411-546).

Selected traces are dense (R, ...) tensors indexed by sorted region id,
with validity masks; CDF references are +inf-padded sorted rows with valid
counts, looked up by ``searchsorted``.  The functions the pickers batch
(``local_centers``, ``neighboring_dists``, ``chromosome_ref_stats``,
``score_candidates`` and the linear scores) take optional leading batch
dims on the selected trace and its centre -- one row per chromosome --
where the JAX package vmaps them.  Medians average the two middle values
(``ops.filters.nanquantile``), as ``jnp.nanmedian`` does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT_PIXEL_SIZE_NM
from ..ops.filters import nanquantile

NAN_MASK = 0.0        # score for spots whose metric is undefined (ref nan_mask)
INF_MASK = -1000.0    # score for -inf outcomes (ref inf_mask)


def pixel_sizes(pixel_size_nm, device) -> torch.Tensor:
    """(3,) float32 nm per voxel on `device` (never float64)."""
    if isinstance(pixel_size_nm, torch.Tensor):
        return pixel_size_nm.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(pixel_size_nm, np.float32),
                           device=device)


def norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm along the last dim, summed left to right in
    elementwise ops: one order for every shape and device, so a distance
    computed twice (a pick and the candidate it is) ties exactly."""
    s = x[..., 0] * x[..., 0]
    for k in range(1, x.shape[-1]):
        s = s + x[..., k] * x[..., k]
    return torch.sqrt(s)


def searchsorted(row: torch.Tensor, values: torch.Tensor,
                 right: bool = False) -> torch.Tensor:
    """``jnp.searchsorted`` on a sorted 1-D row: NaN values rank past every
    element (NaN sorts last there), on every device."""
    values = values.contiguous()
    rank = torch.searchsorted(row, values, right=right)
    return torch.where(torch.isnan(values), row.shape[-1], rank)


class ChromRefStats(NamedTuple):
    """Reference statistics of a chromosome's selected trace (nm); each
    field has the trace's batch shape."""

    ct_dist: torch.Tensor    # median distance to chromosome center
    lc_dist: torch.Tensor    # median distance to local center
    nb_dist: torch.Tensor    # median distance between neighboring regions
    intensity: torch.Tensor  # median intensity


def _masked_median(x: torch.Tensor, mask: torch.Tensor,
                   default: float) -> torch.Tensor:
    """Median of `x` where `mask` along the last dim; `default` if none."""
    med = nanquantile(torch.where(mask, x, float("nan")), 0.5, dim=-1)
    return torch.where(torch.isnan(med), default, med)


def _trace_center(zxys: torch.Tensor, valid: torch.Tensor,
                  chrom_center: Optional[torch.Tensor],
                  px: torch.Tensor) -> torch.Tensor:
    """(..., 3) nm: the given centre (px), else the valid rows' mean."""
    if chrom_center is not None:
        return chrom_center.to(torch.float32) * px
    cnt = valid.sum(dim=-1).clamp_min(1)
    return (torch.where(valid[..., None], zxys, 0.0).sum(dim=-2)
            / cnt[..., None])


def local_centers(sel_zxys: torch.Tensor, sel_valid: torch.Tensor,
                  local_size: int = 5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean of selected spots in a +-(local_size//2) id window, self excluded.

    sel_zxys: (..., R, 3) nm; returns ((..., R, 3) centers, (..., R)
    has_center).  Reference _local_distance (scoring.py:126-156).
    """
    half = (local_size - 1) // 2
    r = sel_zxys.shape[-2]
    w = torch.where(sel_valid[..., None], sel_zxys, 0.0)
    cnt = sel_valid.to(torch.float32)
    sums = torch.zeros_like(w)
    counts = torch.zeros_like(cnt)
    ar = torch.arange(r, device=sel_zxys.device)
    for off in range(-half, half + 1):
        if off == 0:
            continue
        inb = (ar + off >= 0) & (ar + off < r)
        sums = sums + torch.where(inb[:, None],
                                  torch.roll(w, -off, dims=-2), 0.0)
        counts = counts + torch.where(inb, torch.roll(cnt, -off, dims=-1),
                                      0.0)
    return sums / counts.clamp_min(1.0)[..., None], counts > 0


def neighboring_dists(sel_zxys: torch.Tensor, sel_valid: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distance from region i to region i+1 ((..., R), validity mask);
    the last region's entry is 0 and invalid.  Reference
    _neighboring_distance (scoring.py:157-179)."""
    d = norm(sel_zxys[..., 1:, :] - sel_zxys[..., :-1, :])
    ok = sel_valid[..., 1:] & sel_valid[..., :-1]
    return (torch.nn.functional.pad(d, (0, 1)),
            torch.nn.functional.pad(ok, (0, 1)))


def chromosome_ref_stats(sel_spots: torch.Tensor, sel_valid: torch.Tensor,
                         chrom_center: Optional[torch.Tensor] = None,
                         pixel_size_nm=DEFAULT_PIXEL_SIZE_NM,
                         local_size: int = 5) -> ChromRefStats:
    """Median reference stats from a selected trace (reference
    generate_ref_from_chromosome, scoring.py:217-305,
    ref_dist_metric=median).  sel_spots: (..., R, 11) natural rows indexed
    by sorted region id; chrom_center: (..., 3) px or None."""
    px = pixel_sizes(pixel_size_nm, sel_spots.device)
    zxys = sel_spots[..., 1:4] * px
    center = _trace_center(zxys, sel_valid, chrom_center, px)
    ct = norm(zxys - center[..., None, :])
    ct_med = _masked_median(ct, sel_valid, 1000.0)

    lc_centers, lc_has = local_centers(zxys, sel_valid, local_size)
    lc_med = _masked_median(norm(zxys - lc_centers), sel_valid & lc_has,
                            float("inf"))

    nb, nb_ok = neighboring_dists(zxys, sel_valid)
    nb_med = _masked_median(nb, nb_ok, float("inf"))

    ints = sel_spots[..., 0]
    int_med = _masked_median(ints, sel_valid & (ints > 0), 1.0)
    return ChromRefStats(ct_dist=ct_med, lc_dist=lc_med, nb_dist=nb_med,
                         intensity=int_med)


def linear_distance_score(dist: torch.Tensor, ref_dist,
                          weight: float = 1.0,
                          max_limit: float = float("inf")) -> torch.Tensor:
    """-w * d/ref, with an extra -w*(d-max)/ref beyond the limit
    (reference distance_score, scoring.py:23-30, metric='linear')."""
    ref = torch.as_tensor(ref_dist, dtype=torch.float32,
                          device=dist.device).clamp_min(1e-6)
    s = -weight * dist / ref
    over = (dist - max_limit).clamp_min(0.0)
    return s - weight * over / ref


def intensity_score(intensity: torch.Tensor, ref_intensity,
                    weight: float = 1.0) -> torch.Tensor:
    """w * log(I / (I + ref)); I <= 0 maps to INF_MASK
    (reference intensity_score, scoring.py:63-66, metric='linear')."""
    ref = torch.as_tensor(ref_intensity, dtype=torch.float32,
                          device=intensity.device).clamp_min(1e-6)
    i = intensity.clamp_min(1e-12)
    s = weight * torch.log(i / (i + ref))
    return torch.where(intensity > 0, s, INF_MASK)


def score_candidates(cand_spots: torch.Tensor, cand_valid: torch.Tensor,
                     sel_spots: torch.Tensor, sel_valid: torch.Tensor,
                     chrom_center: Optional[torch.Tensor] = None,
                     ref_stats: Optional[ChromRefStats] = None,
                     pixel_size_nm=DEFAULT_PIXEL_SIZE_NM,
                     local_size: int = 5,
                     w_ctdist: float = 2.0, w_lcdist: float = 1.0,
                     w_int: float = 1.0,
                     max_distance_limit: float = 3000.0) -> torch.Tensor:
    """Score every candidate in the (R, M) table -> (..., R, M) scores,
    one table per leading batch entry of the selected trace.

    The E-step scoring of the EM picker (reference
    spot_score_in_chromosome, scoring.py:306-410, metric='linear'):
    score = w_ct * ct + w_lc * lc + w_int * int, with undefined metrics
    contributing NAN_MASK; invalid candidates score -inf.
    """
    px = pixel_sizes(pixel_size_nm, cand_spots.device)
    if ref_stats is None:
        ref_stats = chromosome_ref_stats(sel_spots, sel_valid, chrom_center,
                                         pixel_size_nm, local_size)
    sel_zxys = sel_spots[..., 1:4] * px
    center = _trace_center(sel_zxys, sel_valid, chrom_center, px)
    # each statistic (..., 1, 1) against the (..., R, M) table
    ct_ref, lc_ref, _, int_ref = (
        torch.as_tensor(v, device=cand_spots.device)[..., None, None]
        for v in ref_stats)

    zxys = cand_spots[..., 1:4] * px                 # (R, M, 3)
    ct = norm(zxys - center[..., None, None, :])
    ct_s = linear_distance_score(ct, ct_ref, w_ctdist, max_distance_limit)

    lc_centers, lc_has = local_centers(sel_zxys, sel_valid, local_size)
    lc = norm(zxys - lc_centers[..., None, :])
    lc_s = torch.where(lc_has[..., None] & torch.isfinite(lc_ref),
                       linear_distance_score(lc, lc_ref, w_lcdist,
                                             max_distance_limit),
                       NAN_MASK)

    int_s = intensity_score(cand_spots[..., 0], int_ref, w_int)
    return torch.where(cand_valid, ct_s + lc_s + int_s, float("-inf"))


# ---------------------------------------------------------------------------
# CDF-metric scoring (reference metric='cdf' paths) and utilities
# ---------------------------------------------------------------------------


def radius_of_gyration(zxys: torch.Tensor,
                       valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sqrt(mean |r - <r>|^2) over valid rows (reference
    radius_of_gyration, scoring.py:411-420; NaN rows ignored)."""
    fin = torch.isfinite(zxys).all(dim=-1)
    valid = fin if valid is None else valid & fin
    n = valid.to(torch.float32).sum().clamp_min(1.0)
    mean = torch.where(valid[:, None], zxys, 0.0).sum(dim=0) / n
    r2 = ((zxys - mean[None]) ** 2).sum(dim=-1)
    return torch.sqrt(torch.where(valid, r2, 0.0).sum() / n)


def sort_ref_values(values: torch.Tensor,
                    valid: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Metric population -> (+inf-padded ascending row, valid count): the
    fixed-capacity form of the reference's NaN-dropped ref arrays
    (generate_ref_from_chromosome :254-276, ref_dist_metric='cdf')."""
    keep = torch.isfinite(values)
    if valid is not None:
        keep = keep & valid
    row = torch.sort(torch.where(keep, values, float("inf")).reshape(-1)
                     ).values
    return row, keep.sum().to(torch.int32)


def cum_prob(sorted_ref: torch.Tensor, count: torch.Tensor,
             targets: torch.Tensor, vmin: float = -float("inf"),
             vmax: float = float("inf")) -> torch.Tensor:
    """Windowed weak CDF P(ref <= target) (reference _cum_prob,
    scoring.py:81-107): rescaled to the [vmin, vmax] probability window,
    clipped to [0, 1]; NaN targets count as +inf (CDF 1)."""
    cnt = count.to(torch.float32).clamp_min(1.0)

    def weak(t):
        # clamp to the valid count: side='right' on a +inf target would
        # land past the +inf padding, inflating the denominator window
        r = torch.minimum(searchsorted(sorted_ref, t, right=True),
                          count.long()).to(torch.float32)
        return torch.where(torch.isnan(t), cnt, r) / cnt

    bounds = torch.tensor([vmin, vmax], dtype=torch.float32,
                          device=sorted_ref.device)
    p = weak(targets)
    min_p, max_p = weak(bounds)
    span = max_p - min_p
    p = torch.where(span > 0, (p - min_p) / span.clamp_min(1e-12),
                    p - min_p)
    return p.clamp(0.0, 1.0)


def cdf_distance_score(dist: torch.Tensor, sorted_ref: torch.Tensor,
                       count: torch.Tensor, weight: float = 1.0,
                       distance_limits=(-float("inf"), float("inf")),
                       nan_mask: float = -1000.0) -> torch.Tensor:
    """w * log(1 - CDF(d)) with -inf where the survival mass is zero and
    `nan_mask` for NaN distances (reference distance_score metric='cdf',
    scoring.py:31-47)."""
    surv = 1.0 - cum_prob(sorted_ref, count, dist,
                          vmin=float(min(distance_limits)),
                          vmax=float(max(distance_limits)))
    s = torch.where(surv > 0, weight * torch.log(surv.clamp_min(1e-30)),
                    float("-inf"))
    return torch.where(torch.isnan(dist), nan_mask, s)


def cdf_intensity_score(intensity: torch.Tensor, sorted_ref: torch.Tensor,
                        count: torch.Tensor, weight: float = 1.0,
                        intensity_th: float = 0.0,
                        nan_mask: float = 0.0,
                        inf_mask: float = -1000.0) -> torch.Tensor:
    """w * log(CDF(I)) over the [intensity_th, inf) window, with
    zero-mass outcomes mapped to `inf_mask` (reference intensity_score
    metric='cdf', scoring.py:67-76)."""
    p = cum_prob(sorted_ref, count, intensity, vmin=intensity_th)
    s = torch.where(p > 0, weight * torch.log(p.clamp_min(1e-30)),
                    float("-inf"))
    s = torch.where(torch.isnan(s), nan_mask, s)
    return torch.where(torch.isinf(s), inf_mask, s)


class ChromRefArrays(NamedTuple):
    """Raw metric populations of a selected trace, sorted (+inf padded):
    the ref_dist_metric='cdf' branch of generate_ref_from_chromosome
    (reference scoring.py:296-300)."""
    ct: torch.Tensor
    ct_count: torch.Tensor
    lc: torch.Tensor
    lc_count: torch.Tensor
    nb: torch.Tensor
    nb_count: torch.Tensor
    ints: torch.Tensor
    int_count: torch.Tensor


def chromosome_ref_arrays(sel_spots: torch.Tensor, sel_valid: torch.Tensor,
                          chrom_center: Optional[torch.Tensor] = None,
                          pixel_size_nm=DEFAULT_PIXEL_SIZE_NM,
                          local_size: int = 5,
                          intensity_th: float = 0.0) -> ChromRefArrays:
    """CDF reference populations from a selected trace (R, 11)."""
    px = pixel_sizes(pixel_size_nm, sel_spots.device)
    zxys = sel_spots[:, 1:4] * px
    center = _trace_center(zxys, sel_valid, chrom_center, px)
    ct_row, ct_n = sort_ref_values(norm(zxys - center[None]), sel_valid)

    lc_centers, lc_has = local_centers(zxys, sel_valid, local_size)
    lc_row, lc_n = sort_ref_values(norm(zxys - lc_centers),
                                   sel_valid & lc_has)

    nb, nb_ok = neighboring_dists(zxys, sel_valid)
    nb_row, nb_n = sort_ref_values(nb, nb_ok)

    ints = sel_spots[:, 0]
    int_row, int_n = sort_ref_values(ints, sel_valid & (ints > intensity_th))
    return ChromRefArrays(ct_row, ct_n, lc_row, lc_n, nb_row, nb_n,
                          int_row, int_n)


def candidate_neighbor_dists(cand_zxys: torch.Tensor,
                             cand_valid: torch.Tensor) -> torch.Tensor:
    """(R, M) mean of forward/backward candidate-cloud neighbor distances.

    Per candidate at region r: the median distance to the valid
    candidates of region r+1 (forward) and r-1 (backward), averaged;
    the reference gates BOTH directions on the forward region being
    populated (neighboring_distances :192-203 only fills either when
    `id+1 in ids`), and that quirk is preserved so scores match.
    """
    d = norm(cand_zxys[:-1, :, None] - cand_zxys[1:, None])   # (R-1, M, M')
    nxt_ok = cand_valid[1:]
    fwd = nanquantile(torch.where(nxt_ok[:, None, :], d, float("nan")),
                      0.5, dim=-1)                            # (R-1, M)
    rev = nanquantile(torch.where(cand_valid[:-1, :, None], d,
                                  float("nan")).transpose(1, 2),
                      0.5, dim=-1)                            # (R-1, M')
    fwd = torch.nn.functional.pad(fwd, (0, 0, 0, 1), value=float("nan"))
    rev = torch.nn.functional.pad(rev, (0, 0, 1, 0), value=float("nan"))
    has_fwd = torch.nn.functional.pad(nxt_ok.any(dim=-1), (0, 1))
    nb = torch.nanmean(torch.stack([fwd, rev]), dim=0)
    return torch.where(has_fwd[:, None], nb, float("nan"))


def chromosomal_spot_scores(cand_spots: torch.Tensor,
                            cand_valid: torch.Tensor,
                            sel_spots: torch.Tensor,
                            sel_valid: torch.Tensor,
                            chrom_center: Optional[torch.Tensor] = None,
                            ref_arrays: Optional[ChromRefArrays] = None,
                            pixel_size_nm=DEFAULT_PIXEL_SIZE_NM,
                            local_size: int = 5,
                            w_ctdist: float = 1.0, w_lcdist: float = 1.0,
                            w_int: float = 1.0, w_nbdist: float = 1.0,
                            intensity_th: float = 1.0,
                            distance_limits=(0.0, float("inf")),
                            return_separate: bool = False):
    """4-metric CDF scores of every candidate in the (R, M) table
    (reference chromosomal_spot_scores, scoring.py:423-518): center-dist,
    local-dist, candidate-cloud neighbor-dist, and intensity, each scored
    against the selected trace's CDF reference populations."""
    px = pixel_sizes(pixel_size_nm, cand_spots.device)
    if ref_arrays is None:
        ref_arrays = chromosome_ref_arrays(sel_spots, sel_valid,
                                           chrom_center, pixel_size_nm,
                                           local_size, intensity_th)
    sel_zxys = sel_spots[:, 1:4] * px
    center = _trace_center(sel_zxys, sel_valid, chrom_center, px)

    zxys = torch.where(cand_valid[..., None], cand_spots[..., 1:4] * px,
                       float("nan"))                          # (R, M, 3)
    ct_s = cdf_distance_score(norm(zxys - center), ref_arrays.ct,
                              ref_arrays.ct_count, w_ctdist, distance_limits)

    lc_centers, lc_has = local_centers(sel_zxys, sel_valid, local_size)
    lc = torch.where(lc_has[:, None], norm(zxys - lc_centers[:, None]),
                     float("nan"))
    lc_s = cdf_distance_score(lc, ref_arrays.lc, ref_arrays.lc_count,
                              w_lcdist, distance_limits)

    nb = candidate_neighbor_dists(zxys, cand_valid)
    nb_s = cdf_distance_score(nb, ref_arrays.nb, ref_arrays.nb_count,
                              w_nbdist, distance_limits)

    int_s = cdf_intensity_score(cand_spots[..., 0], ref_arrays.ints,
                                ref_arrays.int_count, w_int, intensity_th)
    if return_separate:
        return ct_s, lc_s, nb_s, int_s
    return torch.where(cand_valid, ct_s + lc_s + nb_s + int_s,
                       float("-inf"))


def generate_cdf_scores(values: torch.Tensor, pos_sorted: torch.Tensor,
                        pos_count: torch.Tensor,
                        neg_sorted: Optional[torch.Tensor] = None,
                        neg_count: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Weak-CDF log odds used by the decoders (reference
    generate_cdf_scores, scoring.py:530-540): log(P(pos <= v) + 0.5/n+),
    normalized by its floor; minus the matching negative-reference term
    when given.  NaN values rank past every reference entry."""
    n_pos = pos_count.to(torch.float32).clamp_min(1.0)
    p = searchsorted(pos_sorted, values, right=True).to(torch.float32) / n_pos
    floor = 0.5 / n_pos
    score = torch.log(p + floor) - torch.log(floor)
    if neg_sorted is not None:
        n_neg = neg_count.to(torch.float32).clamp_min(1.0)
        q = (searchsorted(neg_sorted, values, right=True).to(torch.float32)
             / n_neg)
        neg_floor = 0.5 / n_neg
        score = score - (torch.log(1.0 - q + neg_floor)
                         - torch.log(neg_floor))
    return score


def log_distance_scores(values, ref_length: float = 2000.0) -> torch.Tensor:
    """log(d/ref + 1) (reference scoring.py:542-543)."""
    return torch.log(torch.as_tensor(values).to(torch.float32) / ref_length
                     + 1.0)


def exp_distance_scores(values, ref_length: float = 2000.0) -> torch.Tensor:
    """-exp(d/ref) (reference scoring.py:545-546)."""
    return -torch.exp(torch.as_tensor(values).to(torch.float32) / ref_length)


def normalize_intensities(spots: torch.Tensor, all_intensities: torch.Tensor,
                          valid: Optional[torch.Tensor] = None,
                          method: str = "median") -> torch.Tensor:
    """Divide spot heights by the population's median/mean intensity
    (reference Normalize_Intensities, scoring.py:522-527)."""
    vals = (all_intensities if valid is None
            else torch.where(valid, all_intensities, float("nan")))
    if method == "median":
        norm_val = nanquantile(vals, 0.5)
    elif method == "mean":
        norm_val = torch.nanmean(vals)
    else:
        raise ValueError(f"unsupported method: {method}")
    out = spots.clone()
    out[..., 0] = spots[..., 0] / norm_val.clamp_min(1e-12)
    return out
