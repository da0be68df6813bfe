"""Centre matching across rounds and channels: unique pairing and the
neighbour-consistency check.

The counterpart of the pairing half of ``imageanalysis3_tpu/ops/matching.py``.
Behavior targets (reference ImageAnalysis3):
  * unique centre pairing          spot_tools/matching.py:148-223
    (find_paired_centers: shift ref by rough drift, keep mutually unique
    pairs within a cutoff, return the mean tar-ref shift)
  * neighbour-consistency check    spot_tools/matching.py:224-287
    (check_paired_centers: expected shift from the neighbourhood, drop
    pairs deviating > mean + outlier_sigma * std)
  * bead-match drift               correction_tools/alignment.py:139-216
    (align_beads, use_fft=True)

Fixed-capacity masked centre tables; pairing is one (N, M) distance matrix
with row/column-uniqueness votes; the Delaunay neighbourhood is the k
nearest valid pairs weighted by 1/distance, as in the JAX package.  Drift
convention: the returned drift `d` satisfies ``tar + d ~= ref``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .drift import fft3d_from2d


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
