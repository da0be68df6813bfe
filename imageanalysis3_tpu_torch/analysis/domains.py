"""Domain calling on single-chromosome traces: boundaries, merging,
insulation, contact correlation, domain statistics.

The counterpart of ``imageanalysis3_tpu/analysis/domains.py``.  Behavior
targets (reference ImageAnalysis3 domain_tools/{distance,calling}.py, as
the JAX module lists them).

The JAX package's jitted functions are float32 tensor functions here:
``sliding_window_dist`` gathers the (R, 2w, 2w) windows of a distance map
and takes masked medians by sort (the two middle values averaged, as
``_masked_median`` does there), and ``find_peaks_1d`` ranks peaks by
(-score, index) with a stable sort, the order XLA's top-k gives ties.  Both
take leading batch dims (chromosomes).  The greedy suppression is the
fixpoint of ``kept[t] = ok[t] & no kept earlier peak within distance``:
iterating it from ``ok`` fixes one more rank per step and stops at the
unique fixpoint, the greedy loop's result, after a few steps.

The JAX package's NumPy callers are host loops here as there, with their
O(R^2) work (distance maps, correlation maps, the medians of domain
segments, the windows' signals) as float64 or float32 tensors on the
device: every domain-pair statistic that one step of a loop needs is one
batched gather of the pairs' blocks with masked medians (bit-equal to
``np.median``, which also averages the middle two), and the loop reads
its decision back once a step.  Distance maps are summed over the axes
left to right, as ``np.linalg.norm`` sums three squares.  Starts, peaks
and pairs come back as NumPy arrays, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..decode.scoring import norm
from ..device import as_tensor, host_array
from ..ops.filters import nanquantile

f32 = torch.float32
f64 = torch.float64
_INF = float("inf")
_NAN = float("nan")


# ---------------------------------------------------------------------------
# Masked helpers
# ---------------------------------------------------------------------------


def _masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of x[mask] along the last dim (the two middle values
    averaged, as the JAX package's sort-based median and ``np.median``
    do), NaN where the mask is empty."""
    return nanquantile(torch.where(mask, x, _NAN), 0.5, dim=-1)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    n = mask.sum(dim=-1)
    total = torch.where(mask, x, 0.0).sum(dim=-1)
    return torch.where(n > 0, total / n.clamp_min(1).to(x.dtype), _NAN)


def _distance_map(zxys: torch.Tensor) -> torch.Tensor:
    """(…, R, 3) -> (…, R, R) euclidean distances (NaN passes through)."""
    return norm(zxys[..., :, None, :] - zxys[..., None, :, :])


def _trace(zxys, device) -> torch.Tensor:
    return as_tensor(zxys, device).to(f64)


# ---------------------------------------------------------------------------
# Sliding-window boundary signal and 1D peaks
# ---------------------------------------------------------------------------


def sliding_window_dist(distmap, window: int, metric: str = "median",
                        valid=None, device=None) -> torch.Tensor:
    """Boundary signal at every position of (…, R, R) distance maps (cast
    to float32, as the JAX package casts them): at position i the intra
    distances (upper triangles of the [i-w, i) and [i, i+w) blocks, > 0)
    against the inter distances ([i-w, i) x [i, i+w)).  Metrics 'median',
    'mean', 'insulation', 'normed_insulation'; positions within w/2 of
    either end are 0."""
    dm = as_tensor(distmap, device).to(f32)
    dev = dm.device
    r = dm.shape[-1]
    w = int(window)
    if valid is None:
        valid = torch.ones(dm.shape[:-1], dtype=torch.bool, device=dev)
    else:
        valid = as_tensor(valid, dev).to(torch.bool)
    ok2 = valid[..., :, None] & valid[..., None, :] & torch.isfinite(dm)
    pad_dm = F.pad(dm, (w, w, w, w))
    pad_ok = F.pad(ok2, (w, w, w, w))
    a = torch.arange(2 * w, device=dev)
    tri = a[:, None] < a[None, :]
    left = a < w
    intra_mask = tri & (left[:, None] == left[None, :])
    inter_mask = left[:, None] & ~left[None, :]
    rows = torch.arange(r, device=dev)[:, None] + a[None, :]     # (R, 2w)
    ri, ci = rows[:, :, None], rows[:, None, :]
    blk = pad_dm[..., ri, ci].flatten(-2)                        # (…, R, 4w²)
    okb = pad_ok[..., ri, ci].flatten(-2)
    mask_i = okb & intra_mask.reshape(-1) & (blk > 0)
    mask_o = okb & inter_mask.reshape(-1)
    if metric in ("median", "mean"):
        stat = _masked_median if metric == "median" else _masked_mean
        m_i = stat(blk, mask_i)
        m_o = stat(blk, mask_o)
        d_i = blk - m_i[..., None]
        d_o = blk - m_o[..., None]
        v_i = stat(d_i * d_i, mask_i)
        v_o = stat(d_o * d_o, mask_o)
        out = (m_o - m_i) / torch.sqrt((v_o + v_i).clamp_min(1e-12))
    elif metric == "insulation":
        out = _masked_mean(blk, mask_o) \
            / _masked_mean(blk, mask_i).clamp_min(1e-12)
    elif metric == "normed_insulation":
        m_i = _masked_mean(blk, mask_i)
        m_o = _masked_mean(blk, mask_o)
        out = (m_i - m_o) / (m_i + m_o).clamp_min(1e-12)
    else:
        raise ValueError(metric)
    out = torch.where(torch.isnan(out), 0.0, out)
    i = torch.arange(r, device=dev)
    inside = (i - w // 2 >= 0) & (i + w // 2 < r)
    return torch.where(inside, out, 0.0)


def find_peaks_1d(x, distance: int = 1, min_height: float = -_INF,
                  max_peaks: int = 64, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Strict local maxima of (…, n) float32 signals, then greedy
    suppression from the highest down of any peak within `distance` of a
    kept one -> (idx, kept), kept peaks first in index order, each (…, k)
    with k = min(max_peaks, n)."""
    x = as_tensor(x, device).to(f32)
    n = x.shape[-1]
    xl = torch.roll(x, 1, dims=-1)
    xl[..., 0] = _INF
    xr = torch.roll(x, -1, dims=-1)
    xr[..., -1] = _INF
    is_peak = (x > xl) & (x > xr) & (x >= min_height)
    score = torch.where(is_peak, x, -_INF)
    k = min(int(max_peaks), n)
    idx = torch.sort(score, dim=-1, descending=True, stable=True
                     ).indices[..., :k]
    ok0 = torch.isfinite(score.gather(-1, idx))
    t = torch.arange(k, device=x.device)
    conflict = (((idx[..., :, None] - idx[..., None, :]).abs() < distance)
                & (t[None, :] < t[:, None]))
    kept = ok0
    for _ in range(k):
        new = ok0 & ~(conflict & kept[..., None, :]).any(dim=-1)
        if torch.equal(new, kept):
            break
        kept = new
    key = torch.where(kept, idx, n + 1)
    order = torch.sort(key, dim=-1, stable=True).indices
    return idx.gather(-1, order), kept.gather(-1, order)


def _peaks(x, distance: int, max_peaks: int) -> np.ndarray:
    idx, ok = find_peaks_1d(x, distance=distance, max_peaks=max_peaks)
    return host_array(idx)[host_array(ok)]


def _correlation_map(dm: torch.Tensor) -> torch.Tensor:
    """Row-standardised (NaN-aware, ddof 0) correlation of a distance map."""
    fin = torch.isfinite(dm)
    cnt = fin.sum(dim=1, keepdim=True).to(dm.dtype)
    mu = torch.where(fin, dm, 0.0).sum(dim=1, keepdim=True) / cnt
    dev = torch.where(fin, dm - mu, 0.0)
    sd = torch.sqrt((dev * dev).sum(dim=1, keepdim=True) / cnt) + 1e-12
    zn = torch.where(fin, (dm - mu) / sd, 0.0)
    return zn @ zn.T / dm.shape[0]


def candidate_domain_boundaries(zxys, min_domain_size: int = 5,
                                match_boundary_dist: int = 3,
                                max_peaks: int = 64,
                                device=None) -> np.ndarray:
    """Initial candidate boundary starts (always 0): correlation-map
    discontinuity peaks confirmed by a sliding-window distance peak within
    `match_boundary_dist`."""
    z = _trace(zxys, device)
    valid = torch.isfinite(z).all(dim=1)
    dm = _distance_map(z)
    r = dm.shape[0]
    w = int(min_domain_size)
    slide = sliding_window_dist(dm, w, metric="median", valid=valid)
    slide_peaks = _peaks(slide, w, max_peaks)
    corr = _correlation_map(torch.where(torch.isfinite(dm), dm, _NAN))
    corr_dists = torch.zeros(r, dtype=f64, device=dm.device)
    if r - w > w:
        i = torch.arange(w, r - w, device=dm.device)
        a = torch.arange(w, device=dm.device)
        diff = corr[i[:, None] - w + a] - corr[i[:, None] + a]
        corr_dists[w:r - w] = torch.sqrt((diff * diff).sum(dim=(1, 2)))
    corr_peaks = _peaks(corr_dists, w, max_peaks)
    kept = [0]
    for p in corr_peaks:
        if len(slide_peaks) and (np.abs(slide_peaks - p)
                                 <= match_boundary_dist).any():
            kept.append(int(p))
    return np.unique(kept)


# ---------------------------------------------------------------------------
# Domain-segment statistics, batched over pairs
# ---------------------------------------------------------------------------


def _segment_distances(dm: torch.Tensor, b1s, b2s) -> torch.Tensor:
    """Median-separation distance of each pair of segments (b1s[p],
    b2s[p]) of one distance map -> (P,) float64: the medians of the
    pooled upper triangles of both segments (intra) and of their cross
    block (inter), (m_o - m_i) / sqrt(max(v_o + v_i, 1e-12)) with v the
    medians of squared deviations; NaN where either set is empty."""
    p = len(b1s)
    if p == 0:
        return torch.zeros(0, dtype=f64, device=dm.device)
    bounds = torch.as_tensor(np.asarray([(i0, i1, j0, j1) for (i0, i1), (
        j0, j1) in zip(b1s, b2s)], np.int64), device=dm.device)
    i0, n1 = bounds[:, 0:1], bounds[:, 1:2] - bounds[:, 0:1]
    j0, n2 = bounds[:, 2:3], bounds[:, 3:4] - bounds[:, 2:3]
    width = int(max(e - s for s, e in b1s) + max(e - s for s, e in b2s))
    a = torch.arange(width, device=dm.device)[None]
    first = a < n1
    seg = torch.where(first, 1, torch.where(a < n1 + n2, 2, 0))
    rows = torch.where(first, i0 + a, j0 + a - n1).clamp(0, dm.shape[0] - 1)
    sub = dm[rows[:, :, None], rows[:, None, :]].flatten(1)
    upper = a[0][:, None] < a[0][None, :]
    s1, s2 = seg[:, :, None], seg[:, None, :]
    fin = torch.isfinite(sub)
    intra = (upper & (s1 == s2) & (s1 > 0)).flatten(1) & fin
    inter = ((s1 == 1) & (s2 == 2)).flatten(1) & fin
    m_i = _masked_median(sub, intra)
    m_o = _masked_median(sub, inter)
    d_i = sub - m_i[:, None]
    d_o = sub - m_o[:, None]
    v_i = _masked_median(d_i * d_i, intra)
    v_o = _masked_median(d_o * d_o, inter)
    out = (m_o - m_i) / torch.sqrt((v_o + v_i).clamp_min(1e-12))
    empty = (intra.sum(dim=1) == 0) | (inter.sum(dim=1) == 0)
    return torch.where(empty, _NAN, out)


def _bounds(starts, n: int):
    starts = [int(s) for s in starts]
    return list(zip(starts, starts[1:] + [n]))


def domain_segment_distance(dm, b1: Tuple[int, int],
                            b2: Tuple[int, int], device=None) -> float:
    """Median-separation distance between two domains of a distance map
    (reference domain_distance, metric='median')."""
    dm = as_tensor(dm, device).to(f64)
    return float(_segment_distances(dm, [tuple(b1)], [tuple(b2)])[0])


def domain_pdists(zxys, starts: Sequence[int], device=None) -> torch.Tensor:
    """Condensed pairwise domain distances, float64 on the device."""
    z = _trace(zxys, device)
    dm = _distance_map(z)
    b = _bounds(sorted(int(s) for s in starts), z.shape[0])
    pairs = [(i, j) for i in range(len(b)) for j in range(i + 1, len(b))]
    return _segment_distances(dm, [b[i] for i, _ in pairs],
                              [b[j] for _, j in pairs])


def _merge_on_map(dm: torch.Tensor, starts, dist_th: float,
                  max_iter: int) -> np.ndarray:
    """The merge loop on one distance map.  A merge changes only the two
    adjacent pairs beside the merged domain, so those are the only
    distances computed again (each pair's statistic is its own row)."""
    n = dm.shape[0]
    starts = [int(s) for s in sorted(starts)]
    adj = None
    for _ in range(max_iter):
        if len(starts) <= 1:
            break
        if adj is None:
            b = _bounds(starts, n)
            adj = list(host_array(_segment_distances(dm, b[:-1], b[1:])))
        if not np.any(np.asarray(adj) < dist_th):
            break
        w = int(np.nanargmin(adj))
        del starts[w + 1]
        del adj[w]
        b = _bounds(starts, n)
        redo = [k for k in (w - 1, w) if 0 <= k < len(starts) - 1]
        if redo:
            vals = host_array(_segment_distances(
                dm, [b[k] for k in redo], [b[k + 1] for k in redo]))
            for k, v in zip(redo, vals):
                adj[k] = v
    return np.asarray(starts, int)


def merge_domains(zxys, starts: Sequence[int], dist_th: float = 0.65,
                  max_iter: int = 64, device=None) -> np.ndarray:
    """Iteratively absorb the most-similar adjacent domain pair until all
    adjacent separations reach `dist_th` (one batched step a merge)."""
    return _merge_on_map(_distance_map(_trace(zxys, device)), starts,
                         dist_th, max_iter)


def basic_domain_calling(zxys, min_domain_size: int = 5,
                         match_boundary_dist: int = 3,
                         dist_th: float = 0.65, device=None) -> np.ndarray:
    """Candidate boundaries + iterative merging -> domain start ids."""
    z = _trace(zxys, device)
    starts = candidate_domain_boundaries(z, min_domain_size,
                                         match_boundary_dist)
    return merge_domains(z, starts, dist_th=dist_th)


def arrowhead_transform(distmap, device=None) -> torch.Tensor:
    """A[i, j] = (d(i, i-k) - d(i, i+k)) / (d(i, i-k) + d(i, i+k)) with
    k = j - i for j >= i and i - k >= 0, mirrored below the diagonal, NaN
    elsewhere and where the sum is not finite and positive (float64)."""
    dm = as_tensor(distmap, device).to(f64)
    r = dm.shape[0]
    i = torch.arange(r, device=dm.device)[:, None]
    j = torch.arange(r, device=dm.device)[None, :]
    use = (j >= i) & (2 * i - j >= 0)
    left = dm.gather(1, (2 * i - j).clamp(0, r - 1))
    denom = left + dm
    ok = use & torch.isfinite(denom) & (denom > 0)
    upper = torch.where(ok, (left - dm) / denom, _NAN)
    return torch.where(j >= i, upper, upper.T)


def insulation_domain_calling(distmap, min_domain_size: int = 5,
                              window_size: Optional[int] = None,
                              use_distance: Optional[bool] = None,
                              max_peaks: int = 64,
                              device=None) -> np.ndarray:
    """Insulation-signal domain calling: peaks of the insulation ratio
    (dips for a contact map, told apart by its median when
    `use_distance` is None)."""
    dm = as_tensor(distmap, device).to(f64)
    w = int(window_size) if window_size else 2 * int(min_domain_size)
    dists = sliding_window_dist(dm, w, metric="insulation")
    if use_distance is None:
        nz = dists[dists != 0]
        med = float(nanquantile(nz, 0.5)) if nz.numel() else _NAN
        use_distance = bool(med >= 1.0)
    sig = dists if use_distance else -dists
    peaks = _peaks(sig, min_domain_size - 1, max_peaks)
    peaks = peaks[(peaks > 0) & (peaks < dm.shape[0])]
    return np.unique(np.concatenate([[0], peaks]))


# ---------------------------------------------------------------------------
# Peak prominences (scipy.signal semantics, host-side, as in the JAX
# package: one short signal at a time)
# ---------------------------------------------------------------------------


def _peak_prominences_np(x: np.ndarray, peaks: np.ndarray) -> np.ndarray:
    """Prominence of each peak: height minus the higher of the lowest
    points between it and higher terrain on each side (the walk from the
    peak stops before the first value above its height)."""
    x = np.asarray(x, float)
    proms = np.zeros(len(peaks))
    for k, p in enumerate(np.asarray(peaks, int)):
        h = x[p]
        above = np.nonzero(x[:p] > h)[0]
        left_min = x[(above[-1] + 1 if len(above) else 0):p + 1].min()
        above = np.nonzero(x[p + 1:] > h)[0]
        right_min = x[p:(p + 1 + above[0] if len(above) else len(x))].min()
        proms[k] = h - max(left_min, right_min)
    return proms


def _find_peaks_np(x: np.ndarray, distance: int = 1,
                   min_prominence: Optional[float] = None) -> np.ndarray:
    """scipy.signal.find_peaks(distance=..., prominence=...): strict local
    maxima, prominence screen, highest-first suppression within
    `distance`."""
    x = np.asarray(x, float)
    idx = np.nonzero((x[1:-1] > x[:-2]) & (x[1:-1] > x[2:]))[0] + 1
    if min_prominence is not None and len(idx):
        idx = idx[_peak_prominences_np(x, idx) >= min_prominence]
    if distance > 1 and len(idx):
        keep = np.ones(len(idx), bool)
        for oi in np.argsort(-x[idx]):
            if not keep[oi]:
                continue
            close = np.abs(idx - idx[oi]) < distance
            close[oi] = False
            keep &= ~(close & (x[idx] <= x[idx[oi]]))
            keep[oi] = True
        idx = idx[keep]
    return np.sort(idx)


# ---------------------------------------------------------------------------
# Domain-calling variants
# ---------------------------------------------------------------------------


def iterative_domain_calling(zxys, dom_sz: int = 5, split_level: int = 1,
                             num_iter: int = 5, dist_th: float = 0.65,
                             dist_th_scaling: float = 1.0,
                             match_boundary_dist: int = 3,
                             device=None) -> np.ndarray:
    """Split-merge refinement of basic domain calling: per iteration
    re-run candidate calling inside every domain longer than 2*dom_sz
    (`split_level` times), merge the union, stop when unchanged."""
    z = _trace(zxys, device)
    n = z.shape[0]
    dm = _distance_map(z)
    starts = _merge_on_map(dm, candidate_domain_boundaries(
        z, dom_sz, match_boundary_dist), dist_th, 64)
    for _ in range(int(num_iter)):
        split = list(starts)
        for _ in range(int(split_level)):
            u = np.sort(np.unique(split))
            new = []
            for s, e in zip(u, np.append(u[1:], n)):
                if e - s > 2 * dom_sz:
                    sub = candidate_domain_boundaries(
                        z[s:e], min_domain_size=dom_sz,
                        match_boundary_dist=match_boundary_dist)
                    new += [s + int(b) for b in sub]
            split = np.unique(list(split) + new).astype(int)
        merged = _merge_on_map(dm, split, dist_th * dist_th_scaling, 64)
        if len(merged) == len(starts) and (merged == starts).all():
            break
        starts = merged
    return np.asarray(starts, int)


def sliding_window_domain_calling(coordinates, window_size: int = 5,
                                  distance_metric: str = "median",
                                  min_domain_size: int = 4,
                                  min_prominence: float = 0.25,
                                  reproduce_ratio: float = 0.6,
                                  merge_candidates: bool = True,
                                  dist_th: float = 0.65,
                                  merge_strength_th: float = 1.0,
                                  return_strength: bool = False,
                                  device=None):
    """Multi-window reproducibility domain calling: the boundary signal at
    every window in [window_size, 2*window_size), prominence-screened
    peaks per window, peaks reproduced within ceil(min_domain_size/2) in
    >= reproduce_ratio of the windows kept at their mean position, then
    optionally merged (a boundary survives if the merge keeps it or its
    mean strength exceeds `merge_strength_th`).  `coordinates`: (R, 3) zxys
    or an (R, R) distance map."""
    coords = as_tensor(coordinates, device).to(f64)
    if coords.ndim == 2 and coords.shape[0] == coords.shape[1]:
        mat, zxys = coords, None
    else:
        zxys = coords
        mat = _distance_map(zxys)
    valid = torch.isfinite(zxys if zxys is not None else mat).all(dim=1)
    clean = torch.nan_to_num(mat)
    dist_list = [host_array(sliding_window_dist(
        clean, int(w), metric=distance_metric, valid=valid))
        for w in range(window_size, 2 * window_size)]
    peak_list = [_find_peaks_np(d, distance=min_domain_size,
                                min_prominence=min_prominence)
                 for d in dist_list]
    cand = peak_list[0]
    r = int(np.ceil(min_domain_size / 2))
    coords_mat = np.full((len(peak_list), len(cand)), np.nan)
    coords_mat[0] = cand
    for i, peaks in enumerate(peak_list[1:]):
        for j, p in enumerate(cand):
            hit = peaks[(peaks >= p - r) & (peaks <= p + r)]
            if len(hit):
                coords_mat[i + 1, j] = hit[0]
    keep = (np.isfinite(coords_mat).sum(0)
            >= reproduce_ratio * len(peak_list))
    sel = (np.round(np.nanmean(coords_mat, axis=0)).astype(int)[keep]
           if keep.any() else np.zeros(0, int))
    starts = np.unique(np.concatenate([[0], sel]))
    strengths = np.nanmean([d[starts] for d in dist_list], axis=0)
    if merge_candidates and zxys is not None and len(starts) > 1:
        merged = _merge_on_map(mat, starts, dist_th, 64)
        kept = np.array([s for i, s in enumerate(starts)
                         if s in merged or strengths[i] > merge_strength_th],
                        int)
    else:
        kept = starts
    if return_strength:
        ks = np.array([s for st, s in zip(starts, strengths) if st in kept])
        return kept, ks
    return kept


# ---------------------------------------------------------------------------
# Contact-correlation domain calling
# ---------------------------------------------------------------------------


def neighboring_distance(zxys, radius: int = 5, device=None) -> torch.Tensor:
    """Distance of each point to the NaN-aware mean of its +-radius
    neighbours (float64; the mean summed in index order, as NumPy sums a
    column)."""
    z = _trace(zxys, device)
    n = z.shape[0]
    i = torch.arange(n, device=z.device)
    acc = torch.zeros_like(z)
    cnt = torch.zeros_like(z)
    for o in range(-radius, radius + 1):
        if o == 0:
            continue
        j = i + o
        inb = (j >= 0) & (j < n)
        v = z[j.clamp(0, n - 1)]
        ok = inb[:, None] & ~torch.isnan(v)
        acc = acc + torch.where(ok, v, 0.0)
        cnt = cnt + ok.to(f64)
    return norm(acc / cnt - z)


def merge_domain_by_contact_correlation(zxys, starts: Sequence[int],
                                        contact_th: float = 500.0,
                                        corr_th: float = 0.5,
                                        device=None) -> np.ndarray:
    """Merge adjacent domains while any adjacent-pair contact frequency
    exceeds `corr_th`."""
    from .structure import domain_contact_freq

    dm = _distance_map(_trace(zxys, device))
    starts = np.sort(np.asarray(starts, int))
    if 0 not in starts:
        starts = np.concatenate([[0], starts])
    while len(starts) > 1:
        adj = np.diag(host_array(domain_contact_freq(dm, starts,
                                                     contact_th)), 1)
        if not (adj > corr_th).any():
            break
        starts = np.delete(starts, int(np.argmax(adj)) + 1)
    return starts


def contact_correlation_domain_calling(zxys, remove_outlier_th: float = 750.0,
                                       domain_size: int = 5,
                                       cand_domain_th: float = 0.3,
                                       contact_th: float = 500.0,
                                       corr_th: float = 0.5,
                                       device=None) -> np.ndarray:
    """Contact-frequency merged domain calling: drop NaN points and
    neighbour-distance outliers, call candidates from the sliding-window
    signal, merge by adjacent contact frequency, map back to region
    indices."""
    z = _trace(zxys, device)
    good = np.where(host_array(torch.isfinite(z).all(dim=1)))[0]
    gz = z[torch.as_tensor(good, device=z.device)]
    nb = host_array(neighboring_distance(gz))
    outliers = _find_peaks_np(np.nan_to_num(nb),
                              min_prominence=remove_outlier_th)
    kept = np.setdiff1d(np.arange(len(gz)), outliers)
    kz = gz[torch.as_tensor(kept, device=z.device)]
    sig = host_array(sliding_window_dist(_distance_map(kz), domain_size))
    cand = _find_peaks_np(sig, distance=max(int(domain_size / 2), 1),
                          min_prominence=cand_domain_th)
    merged = merge_domain_by_contact_correlation(kz, cand, contact_th,
                                                 corr_th)
    return good[kept[merged]]


def find_matched_starts(starts, ref_starts, dom_sz: int = 5,
                        ignore_multi_match: bool = True) -> np.ndarray:
    """Match called domain starts to reference starts within dom_sz/2; a
    start matching several references is dropped when
    `ignore_multi_match`, else takes the first."""
    ref = np.asarray(ref_starts, int)
    out = []
    for s in np.asarray(starts, int):
        hits = np.where(np.abs(ref - s) <= dom_sz // 2)[0]
        if len(hits) == 1 or (len(hits) > 1 and not ignore_multi_match):
            out.append(ref[hits[0]])
    return np.asarray(out, int)


# ---------------------------------------------------------------------------
# Domain difference statistics (KS / t-test)
# ---------------------------------------------------------------------------


def domain_stat(coordinates, dom1_bounds: Sequence[int],
                dom2_bounds: Sequence[int], method: str = "ks",
                normalization_mat=None, return_pval: bool = True,
                device=None):
    """Signed separation statistic between two domain segments: their
    pooled intra distances against their inter distances, by a two-sample
    KS statistic signed by median(inter) - median(intra), or a t-test on
    distances scaled by the pooled median.  `coordinates` is an (R, 3)
    trace or an (R, R) matrix (square wins); the distance map is built on
    the device and the two samples go to scipy on the host."""
    method = str(method).lower()
    if method not in ("ks", "ttest"):
        raise ValueError(f"method must be ks|ttest, got {method}")
    coords = as_tensor(coordinates, device).to(f64)
    s1, e1 = (int(b) for b in dom1_bounds)
    s2, e2 = (int(b) for b in dom2_bounds)
    if coords.ndim != 2:
        raise ValueError("coordinates must be 2D")
    if coords.shape[0] == coords.shape[1]:
        mat = coords
    elif coords.shape[1] == 3:
        mat = _distance_map(coords)
    else:
        raise ValueError("coordinates must be (R, 3) or a square matrix")
    b1 = host_array(mat[s1:e1, s1:e1])
    b2 = host_array(mat[s2:e2, s2:e2])
    intra = [b1[np.triu_indices(len(b1), 1)],
             b2[np.triu_indices(len(b2), 1)]]
    inter = host_array(mat[s1:e1, s2:e2]).ravel()
    if normalization_mat is not None:
        norm = host_array(normalization_mat).astype(np.float64)
        n1 = norm[s1:e1, s1:e1]
        n2 = norm[s2:e2, s2:e2]
        intra = [intra[0] / n1[np.triu_indices(len(n1), 1)],
                 intra[1] / n2[np.triu_indices(len(n2), 1)]]
        inter = inter / norm[s1:e1, s2:e2].ravel()
    intra = np.concatenate(intra)
    kept_intra = intra[np.isfinite(intra)]
    kept_inter = inter[np.isfinite(inter)]
    if len(kept_intra) == 0 or len(kept_inter) == 0:
        return (0.0, 1.0) if return_pval else 0.0
    if method == "ks":
        from scipy.stats import ks_2samp
        sign = np.sign(np.nanmedian(inter) - np.nanmedian(intra))
        stat, pval = ks_2samp(kept_inter, kept_intra)
        stat = sign * stat
    else:
        from scipy.stats import ttest_ind
        scale = np.mean([np.nanmedian(kept_inter), np.nanmedian(kept_intra)])
        stat, pval = ttest_ind(kept_inter / scale, kept_intra / scale)
    return (float(stat), float(pval)) if return_pval else float(stat)


def domain_neighboring_stats(coordinates, domain_starts: Sequence[int],
                             method: str = "ks", use_local: bool = True,
                             min_dom_sz: int = 5, normalization_mat=None,
                             return_pval: bool = True, device=None):
    """Per-boundary separation statistics between adjacent domains; with
    `use_local` each side is clipped to at most twice the other domain's
    size around the shared boundary."""
    starts = np.sort(np.asarray(domain_starts, int))
    coords = as_tensor(coordinates, device).to(f64)
    if coords.ndim == 2 and coords.shape[1] == 3 \
            and coords.shape[0] != coords.shape[1]:
        coords = _distance_map(coords)
    ends = np.concatenate([starts[1:], [coords.shape[0]]])
    stats, pvals = [], []
    for i in range(len(starts) - 1):
        s1, e1 = int(starts[i]), int(ends[i])
        s2, e2 = int(starts[i + 1]), int(ends[i + 1])
        if use_local:
            ns1 = max(s1, e1 - 2 * max(e2 - s2, min_dom_sz))
            ne2 = min(e2, s2 + 2 * max(e1 - s1, min_dom_sz))
            s1, e2 = ns1, ne2
        res = domain_stat(coords, (s1, e1), (s2, e2), method=method,
                          normalization_mat=normalization_mat,
                          return_pval=return_pval)
        if return_pval:
            stats.append(res[0])
            pvals.append(res[1])
        else:
            stats.append(res)
    if return_pval:
        return np.asarray(stats), np.asarray(pvals)
    return np.asarray(stats)
