"""Centre matching across rounds and channels: pairing, outlier checks,
bead alignment, cross-experiment alignment and matched-centre fits.

The counterpart of ``imageanalysis3_tpu/ops/matching.py``.
Behavior targets (reference ImageAnalysis3):
  * unique centre pairing          spot_tools/matching.py:148-223
    (find_paired_centers: shift ref by rough drift, keep mutually unique
    pairs within a cutoff, return the mean tar-ref shift)
  * neighbour-consistency check    spot_tools/matching.py:224-287
    (check_paired_centers: expected shift from the neighbourhood, drop
    pairs deviating > mean + outlier_sigma * std)
  * bead-match drift               correction_tools/alignment.py:139-216
    (align_beads, use_fft=True)
  * re-mount rigid alignment       correction_tools/alignment.py:7-77
  * spot translation and matching  spot_tools/translating.py:95-149,
    spot_tools/matching.py:6-147, spot_tools/relabelling.py:6-31

Fixed-capacity masked centre tables; pairing is one (N, M) distance matrix
with row/column-uniqueness votes; the Delaunay neighbourhood is the k
nearest valid pairs weighted by 1/distance, as in the JAX package.  Drift
convention: the returned drift `d` satisfies ``tar + d ~= ref``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import as_tensor
from .drift import fft3d_from2d
from .filters import full_f32_matmul


class PairedCenters(NamedTuple):
    drift: torch.Tensor       # (3,) mean(ref - tar) over kept pairs
    tar: torch.Tensor         # (N, 3) tar centres (row i valid iff mask[i])
    ref: torch.Tensor         # (N, 3) matched ref centres
    mask: torch.Tensor        # (N,) pair validity
    n_pairs: torch.Tensor     # () int32


def pairwise_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, M) Euclidean distances, summed over the axes in order, as
    ``jnp.linalg.norm(a[:, None] - b[None], axis=-1)`` forms them."""
    d = a[:, None, :] - b[None, :, :]
    return torch.sqrt((d * d).sum(dim=-1))


def find_paired_centers(tar_cts: torch.Tensor, tar_valid: torch.Tensor,
                        ref_cts: torch.Tensor, ref_valid: torch.Tensor,
                        drift: Optional[torch.Tensor] = None,
                        cutoff: float = 2.0) -> PairedCenters:
    """Uniquely pair target centres to (drift-shifted) reference centres:
    a candidate iff |tar + drift - ref| <= cutoff, kept iff the match is
    unique in both its row and its column."""
    if drift is None:
        drift = torch.zeros(3, dtype=tar_cts.dtype, device=tar_cts.device)
    d = pairwise_distances(tar_cts + drift[None], ref_cts)
    within = (d <= cutoff) & tar_valid[:, None] & ref_valid[None, :]
    row_ct = within.sum(dim=1)
    col_ct = within.sum(dim=0)
    # torch.argmax has no bool kernel; like jnp.argmax it returns the first
    # maximum
    j = torch.argmax(within.to(torch.uint8), dim=1)
    pair_ok = (row_ct == 1) & (col_ct[j] == 1)
    ref_matched = ref_cts[j]
    n = pair_ok.sum()
    shift = torch.where(pair_ok[:, None], ref_matched - tar_cts,
                        0.0).sum(dim=0) / n.clamp_min(1)
    return PairedCenters(drift=shift, tar=tar_cts, ref=ref_matched,
                         mask=pair_ok, n_pairs=n.to(torch.int32))


def check_paired_centers(pairs: PairedCenters, outlier_sigma: float = 1.5,
                         k: int = 6) -> PairedCenters:
    """Drop pairs whose shift deviates from their neighbourhood's expected
    shift (the k nearest valid pairs, weighted by 1/distance) by more than
    mean + outlier_sigma * std of the deviations."""
    shifts = pairs.ref - pairs.tar
    n = shifts.shape[0]
    inf = float("inf")
    d = pairwise_distances(pairs.ref, pairs.ref)
    d = torch.where(pairs.mask[:, None] & pairs.mask[None, :], d, inf)
    d.fill_diagonal_(inf)
    neg, idx = torch.topk(-d, min(k, n), dim=1)
    w = torch.where(torch.isfinite(neg), 1.0 / (-neg).clamp_min(1e-6), 0.0)
    w = w / w.sum(dim=1, keepdim=True).clamp_min(1e-12)
    expected = torch.einsum("nk,nkd->nd", w, shifts[idx])
    e = expected - shifts
    diff = torch.sqrt((e * e).sum(dim=1))
    diff_m = torch.where(pairs.mask, diff, float("nan"))
    mean = torch.nanmean(diff_m)
    std = torch.sqrt(torch.nanmean((diff_m - mean) ** 2))
    keep = pairs.mask & (diff < mean + outlier_sigma * std)
    n_kept = keep.sum()
    drift = torch.where(keep[:, None], shifts, 0.0).sum(dim=0) \
        / n_kept.clamp_min(1)
    return PairedCenters(drift=drift, tar=pairs.tar, ref=pairs.ref,
                         mask=keep, n_pairs=n_kept.to(torch.int32))


def align_beads(tar_cts: torch.Tensor, tar_valid: torch.Tensor,
                ref_cts: torch.Tensor, ref_valid: torch.Tensor,
                tar_im, ref_im, match_distance_th: float = 2.0,
                outlier_sigma: float = 1.5, check: bool = True,
                k: int = 6) -> PairedCenters:
    """Bead-match drift: FFT rough alignment (:func:`fft3d_from2d`), unique
    pairing, neighbour check, mean residual drift; the checked pairing
    only where more than 3 pairs survive it, else the unchecked one.
    Returns drift with ``tar + drift ~= ref``."""
    rough = fft3d_from2d(tar_im, ref_im, device=tar_cts.device)
    pairs = find_paired_centers(tar_cts, tar_valid, ref_cts, ref_valid,
                                rough.to(tar_cts.dtype),
                                cutoff=match_distance_th)
    if not check:
        return pairs
    checked = check_paired_centers(pairs, outlier_sigma, k=k)
    use = checked.n_pairs > 3
    return PairedCenters(
        drift=torch.where(use, checked.drift, pairs.drift),
        tar=pairs.tar, ref=pairs.ref,
        mask=torch.where(use, checked.mask, pairs.mask),
        n_pairs=torch.where(use, checked.n_pairs, pairs.n_pairs))


# ---------------------------------------------------------------------------
# Re-mount / cross-experiment rigid alignment
# ---------------------------------------------------------------------------


def rigid_transform_from_points(before, after, device=None):
    """Best-fit rigid transform (R, t) with after ~= before @ R + t
    (float64 on the device): the SVD of the centred cross covariance,
    reflections removed by flipping U's last column (Kabsch)."""
    before = as_tensor(before, device).to(torch.float64)
    after = as_tensor(after, before.device).to(torch.float64)
    c_before = before.mean(dim=0)
    c_after = after.mean(dim=0)
    h = (before - c_before).T @ (after - c_after)
    u, _, vt = torch.linalg.svd(h)
    if float(torch.linalg.det(u @ vt)) < 0:
        u = u.clone()
        u[:, -1] = -u[:, -1]
    r = u @ vt
    return r, -c_before @ r + c_after


def align_manual_points(pos_file_before: str, pos_file_after: str,
                        device=None):
    """Two comma-delimited stage-position files -> (R, t)."""
    return rigid_transform_from_points(
        np.loadtxt(pos_file_before, delimiter=","),
        np.loadtxt(pos_file_after, delimiter=","), device=device)


def translate_spot_coordinates(spots, rotation_xy, center_xy, drift=None,
                               device=None) -> torch.Tensor:
    """Rotate spot xy about the image centre and shift: (N, 11) natural
    rows into another experiment's frame; z passes through."""
    spots = as_tensor(spots, device)
    dev = spots.device
    center_xy = as_tensor(center_xy, dev).to(spots.dtype)
    rot = as_tensor(rotation_xy, dev).to(spots.dtype)
    out = spots.clone()
    with full_f32_matmul():
        out[:, 2:4] = ((spots[:, 2:4] - center_xy[None]) @ rot
                       + center_xy[None])
    if drift is not None:
        out[:, 1:4] = out[:, 1:4] + as_tensor(drift, dev).to(spots.dtype)
    return out


def select_matched_spots(cand_spots, ref_zxy, dist_th_nm: float,
                         pixel_size_nm=(200.0, 108.0, 108.0), device=None):
    """Brightest candidate within `dist_th_nm` of a reference position ->
    (row, found); a NaN row when none is (float64 distances)."""
    cand = as_tensor(cand_spots, device)
    dev = cand.device
    if cand.numel() == 0:
        return torch.full((11,), float("nan"), dtype=torch.float64,
                          device=dev), False
    cand = torch.atleast_2d(cand)
    px = torch.as_tensor(np.asarray(pixel_size_nm, np.float64), device=dev)
    d = (cand[:, 1:4].to(torch.float64)
         - as_tensor(ref_zxy, dev).to(torch.float64)[None]) * px
    dist = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                      + d[:, 2] * d[:, 2])
    keep = dist <= dist_th_nm
    if not bool(keep.any()):
        return torch.full((11,), float("nan"), dtype=torch.float64,
                          device=dev), False
    sub = cand[keep]
    return sub[torch.argmax(sub[:, 0])], True


def fit_matched_centers(im, ref_centers, match_distance_th: float = 3.0,
                        th_seed: float = 300.0, max_num_seeds: int = 256,
                        device=None, **fit_kwargs) -> PairedCenters:
    """Fit spot centres in `im` (``gaussian_fit.get_centers``: the seeding
    classifier, the gather and the LM fit) and uniquely pair them to
    `ref_centers` within `match_distance_th` px."""
    from .gaussian_fit import get_centers

    centers, valid = get_centers(im, th_seed=th_seed,
                                 max_num_seeds=max_num_seeds, device=device,
                                 **fit_kwargs)
    dev = centers.device
    ref = torch.as_tensor(np.atleast_2d(np.asarray(ref_centers, np.float32)),
                          device=dev)
    n = max(ref.shape[0], centers.shape[0])
    ref_p = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    ref_p[:ref.shape[0]] = ref
    ref_v = torch.zeros(n, dtype=torch.bool, device=dev)
    ref_v[:ref.shape[0]] = True
    cen_p = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    cen_p[:centers.shape[0]] = centers
    cen_v = torch.zeros(n, dtype=torch.bool, device=dev)
    cen_v[:valid.shape[0]] = valid
    return find_paired_centers(cen_p, cen_v, ref_p, ref_v,
                               cutoff=match_distance_th)


def generate_recombined_spots(repeat_cand_spots, repeat_ids,
                              original_cand_spots, original_ids):
    """Replace relabelled regions' candidates with the repeat-hyb fits."""
    if len(repeat_cand_spots) != len(repeat_ids):
        raise IndexError("repeat spots/ids length mismatch")
    if len(original_cand_spots) != len(original_ids):
        raise IndexError("original spots/ids length mismatch")
    out = list(original_cand_spots)
    original_ids = np.asarray(original_ids)
    for rid, spots in zip(repeat_ids, repeat_cand_spots):
        idx = np.where(original_ids == rid)[0]
        if len(idx) != 1:
            raise ValueError(f"region {rid} has {len(idx)} matches")
        out[int(idx[0])] = spots
    return out


def accumulate_sequential_drifts(step_drifts, device=None) -> torch.Tensor:
    """Cumulative float32 drift against round 0 from consecutive-round
    step drifts: (R-1, 3) -> (R, 3), row 0 zeros, row i the sum of steps
    1..i."""
    cum = torch.cumsum(as_tensor(step_drifts, device).to(torch.float32),
                       dim=0)
    return torch.cat([torch.zeros((1, 3), dtype=cum.dtype,
                                  device=cum.device), cum])
