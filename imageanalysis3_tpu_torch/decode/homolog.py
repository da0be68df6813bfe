"""Homolog assignment: decoded spot groups -> per-homolog chromosome traces.

The counterpart of ``imageanalysis3_tpu/decode/homolog.py``.  Behavior
targets (reference classes/decode.py, DNA_Merfish_Decoder): the "BB"
homolog-center init (:2079-2138), the five score metrics (:1900-1995), the
weak-percentile CDF scores (:2007-2070), the iterative E/M homolog
assignment (:951-1023 + :1598-1662) and the per-region trace summary
(:1214-1285 + :1361-1370); see the JAX module's docstring for the map.

Groups are fixed-capacity masked tensors.  The BB init evaluates every
center pair as one (G, G, G) masked tensor program; the E/M loop's
``lax.while_loop`` is a host loop (one synchronisation per iteration) whose
E-step scores every (group, homolog, metric) cell at once and whose M-step
is a group -> best homolog argmax and a (region, homolog) -> best
preferring group scatter.  ``torch.topk`` is used only for k-nearest
distance means, where tie order cannot change the result.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device

DEFAULT_METRIC_WEIGHTS = (1.0, 1.0, 1.0, 1.0, 1.0)   # decode.py:709
N_NEIGHBORS = 10                                      # decode.py:1901
_GREATER_FLAGS = (True, False, False, False, False)   # decode.py:2030
_INF = float("inf")
_NAN = float("nan")


def _rank_cdf(values: torch.Tensor, ok: torch.Tensor,
              bigger_is_better: bool) -> torch.Tensor:
    """Population rank in (0, 1] (BB-init scoring, decode.py:2107-2111)."""
    v = values if bigger_is_better else -values
    n_ok = ok.sum().clamp_min(1)
    s = torch.sort(torch.where(ok, v, _INF)).values
    ranks = torch.searchsorted(s, v.contiguous(), right=True)
    return (ranks.to(torch.float32) / n_ok).clamp(1e-4, 1.0)


def _pairwise(c: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(c[:, None] - c[None], dim=-1)


def init_homolog_centers(centroids: torch.Tensor, region_ids: torch.Tensor,
                         valid: torch.Tensor):
    """Two homolog centers from decoded group centroids (reference
    init_homolog_centers_BB, decode.py:2079-2138).

    For every pair of candidate centers, groups split to the nearer one;
    score = rank(coverage: regions present on both sides) x
    rank(-mean within-side distance); the best pair's centroids are the
    centers.  centroids: (G, 3) nm.
    """
    g = centroids.shape[0]
    dev = centroids.device
    d = _pairwise(centroids)
    d = torch.where(valid[None, :] & valid[:, None], d, 0.0)
    # side2[i1, i2, k]: group k is closer to i2 than i1
    side2 = d[:, None, :] > d[None, :, :]
    okk = valid[None, None, :]
    s1, s2 = ~side2 & okk, side2 & okk
    n2 = s2.sum(dim=-1).clamp_min(1)
    n1 = s1.sum(dim=-1).clamp_min(1)
    # mean within-side distance to the respective candidate center
    rg = (torch.where(s1, d[:, None, :], 0.0).sum(-1) / n1
          + torch.where(s2, d[None, :, :], 0.0).sum(-1) / n2)
    # coverage: regions with >= 1 group on each side
    rid = region_ids.to(torch.int64)
    uniq = torch.unique(rid)
    uniq = torch.cat([uniq, torch.full((g - uniq.shape[0],), -1,
                                       dtype=uniq.dtype, device=dev)])
    onehot = ((rid[None, :] == uniq[:, None]) & valid[None, :]).float()
    cov1 = torch.einsum("rg,abg->abr", onehot, s1.float()) > 0
    cov2 = torch.einsum("rg,abg->abr", onehot, s2.float()) > 0
    cov = (cov1 & cov2).sum(dim=-1).to(torch.float32)

    ar = torch.arange(g, device=dev)
    pair_ok = valid[:, None] & valid[None, :] & (ar[:, None] > ar[None, :])
    flat_ok = pair_ok.reshape(-1)
    r_rg = _rank_cdf(rg.reshape(-1), flat_ok, bigger_is_better=False)
    r_cov = _rank_cdf(cov.reshape(-1), flat_ok, bigger_is_better=True)
    score = torch.where(flat_ok, r_rg * r_cov, -_INF)
    best = torch.argmax(score)
    return centroids[best // g], centroids[best % g]


def init_centers_kmeans(centroids: np.ndarray, valid: np.ndarray,
                        n_homologs: int, n_iters: int = 25,
                        seed: int = 0) -> np.ndarray:
    """K-means homolog-center init for n_homologs != 2 (reference
    initial_assign_homologs_by_chr, decode.py:1536-1596, sklearn KMeans).
    Host-side numpy: farthest-point seeding + Lloyd iterations."""
    pts = np.asarray(centroids, np.float64)[np.asarray(valid, bool)]
    if len(pts) < n_homologs:
        raise ValueError(f"need >= {n_homologs} valid groups for k-means")
    rng = np.random.default_rng(seed)
    centers = [pts[rng.integers(len(pts))]]
    for _ in range(n_homologs - 1):
        d2 = np.min([np.sum((pts - c) ** 2, 1) for c in centers], axis=0)
        centers.append(pts[int(np.argmax(d2))])
    centers = np.asarray(centers)
    for _ in range(n_iters):
        lab = np.argmin(
            ((pts[:, None] - centers[None]) ** 2).sum(-1), axis=1)
        for k in range(n_homologs):
            if np.any(lab == k):
                centers[k] = pts[lab == k].mean(0)
    return centers.astype(np.float32)


# ---------------------------------------------------------------------------
# Score metrics (reference generate_score_metrics, decode.py:1900-1995)
# ---------------------------------------------------------------------------


def _mean_nearest(d: torch.Tensor, k: int) -> torch.Tensor:
    """Mean of the k smallest entries along the last axis (values only, so
    the order of ties is irrelevant)."""
    return torch.topk(d, k, dim=-1, largest=False).values.mean(dim=-1)


def _chr_tree_nb_dists(centroids: torch.Tensor, valid: torch.Tensor,
                       n_neighbors: int) -> torch.Tensor:
    """(G,) mean distance to the n_neighbors nearest group centroids (the
    "chromosome tree" of decode.py:1025; self included at d=0 as the
    KDTree query does).  NaN when the tree holds < n_neighbors points."""
    d = torch.where(valid[None, :], _pairwise(centroids), _INF)
    out = _mean_nearest(d, min(n_neighbors, centroids.shape[0]))
    return torch.where(valid.sum() >= n_neighbors, out, _NAN)


def _trace_nb_dists(centroids: torch.Tensor, trace: torch.Tensor,
                    trace_valid: torch.Tensor, chr_nb: torch.Tensor,
                    n_neighbors: int) -> torch.Tensor:
    """(G, H) mean distance to the n_neighbors nearest points of each
    homolog's trace (reference neighboring_dists over per-homolog KDTrees,
    decode.py:1931-1936 + tree rebuild :1003-1009: an empty trace falls
    back to the chromosome tree; a short one yields NaN)."""
    d = torch.linalg.norm(centroids[None, :, None] - trace[:, None, :],
                          dim=-1)                          # (H, G, R)
    d = torch.where(trace_valid[:, None, :], d, _INF)
    mean_k = _mean_nearest(d, min(n_neighbors, trace.shape[1]))   # (H, G)
    n_valid = trace_valid.sum(dim=1)                       # (H,)
    per_h = torch.where(n_valid[:, None] >= n_neighbors, mean_k, _NAN)
    per_h = torch.where(n_valid[:, None] == 0, chr_nb[None, :], per_h)
    return per_h.T                                         # (G, H)


def _cdf_weak(values: torch.Tensor, refs_sorted: torch.Tensor,
              n_refs: torch.Tensor, greater: bool) -> torch.Tensor:
    """Reference cdf_scores (decode.py:2018-2027):
    percentileofscore(refs, v, kind='weak')/100 + 0.5/n for greater,
    1 - percentileofscore/100 + 0.5/n otherwise.  NaN refs sort to the end
    (counted in n, never <= v), NaN values stay NaN."""
    count = torch.searchsorted(refs_sorted,
                               torch.nan_to_num(values, nan=0.0).contiguous(),
                               right=True).to(torch.float32)
    n = n_refs.to(torch.float32).clamp_min(1.0)
    cdf = count / n + 0.5 / n if greater else 1.0 - count / n + 0.5 / n
    return torch.where(torch.isnan(values), _NAN, cdf)


def score_groups(metrics: torch.Tensor, valid: torch.Tensor,
                 n_spots: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
    """metrics (G, H, 5) -> final scores (G, H).

    Population refs per metric = all (valid group, homolog) cells
    (reference collect_metrics, decode.py:2000-2010); scores = log
    weak-CDF, weighted nansum, normalized by 1/n_spots (generate_scores
    :2029-2043 + summarize_score :2045-2057)."""
    g, h, m = metrics.shape
    flat_ok = valid.repeat_interleave(h)
    n_refs = flat_ok.sum()
    finals = torch.zeros((g, h), dtype=torch.float32, device=metrics.device)
    for i in range(m):
        vals = metrics[:, :, i]
        refs = torch.where(flat_ok, vals.reshape(-1), _NAN)
        refs_sorted = torch.sort(torch.nan_to_num(refs, nan=_INF)).values
        cdf = _cdf_weak(vals, refs_sorted, n_refs, _GREATER_FLAGS[i])
        finals = finals + torch.nan_to_num(weights[i] * torch.log(cdf),
                                           nan=0.0)
    return finals / n_spots.clamp_min(1)[:, None].to(torch.float32)


def _percentile_linear(values: torch.Tensor, ok: torch.Tensor,
                       pct: float) -> torch.Tensor:
    """scipy.stats.scoreatpercentile (fraction-interpolated) over the
    masked population (reference score_th, decode.py:1602-1609)."""
    s = torch.sort(torch.where(ok, values, _INF)).values
    n_ok = ok.sum().clamp_min(1)
    rank = pct / 100.0 * (n_ok - 1).to(torch.float32)
    last = values.shape[0] - 1
    lo = torch.floor(rank).to(torch.int64).clamp(0, last)
    hi = (lo + 1).clamp(0, last)
    frac = rank - lo.to(torch.float32)
    hi = torch.where(hi >= n_ok, lo, hi)
    return s[lo] * (1.0 - frac) + s[hi] * frac


def _nanmedian_rows(x: torch.Tensor) -> torch.Tensor:
    """Median over axis 0 ignoring NaN rows (numpy's nanmedian: the mean of
    the two middle values for an even count); NaN where all are NaN."""
    nan = torch.isnan(x)
    s = torch.sort(torch.where(nan, _INF, x), dim=0).values
    cnt = (~nan).sum(dim=0)
    lo = ((cnt - 1) // 2).clamp_min(0)
    hi = (cnt // 2).clamp_min(0)
    a = s.gather(0, lo[None])[0]
    b = s.gather(0, hi[None])[0]
    return torch.where(cnt > 0, 0.5 * a + 0.5 * b, _NAN)


# ---------------------------------------------------------------------------
# E/M assignment
# ---------------------------------------------------------------------------


class HomologResult(NamedTuple):
    zxys: torch.Tensor         # (H, R, 3) per-homolog traces (nm, NaN missing)
    zxys_valid: torch.Tensor   # (H, R)
    sel_group: torch.Tensor    # (H, R) selected group index, -1 none
    member_zxys: torch.Tensor  # (H, R, S, 3) selected groups' member spots
    member_ok: torch.Tensor    # (H, R, S)
    flags: torch.Tensor        # (G,) homolog index per group, -1 unassigned
    final_scores: torch.Tensor  # (G, H) last E-step scores
    score_th: torch.Tensor     # () population score threshold
    centers: torch.Tensor      # (H, 3) final homolog centers
    n_iters: int


def assign_groups_to_homologs(centroids: torch.Tensor,
                              mean_intensity: torch.Tensor,
                              cv_intensity: torch.Tensor,
                              internal_dists: torch.Tensor,
                              region_index: torch.Tensor,
                              n_spots: torch.Tensor,
                              valid: torch.Tensor,
                              member_zxys: torch.Tensor,
                              member_ok: torch.Tensor,
                              init_centers: torch.Tensor,
                              n_regions: int,
                              weights=DEFAULT_METRIC_WEIGHTS,
                              score_th_percentile: float = 1.0,
                              max_iters: int = 10,
                              n_neighbors: int = N_NEIGHBORS,
                              flag_diff_th: float = 0.005) -> HomologResult:
    """Iterative E/M assignment of decoded groups to homologs.

    centroids (G, 3) nm; mean_intensity/cv_intensity (G,); internal_dists
    (G,) median within-group distance; region_index (G,) in [0,
    n_regions); n_spots (G,); member_zxys (G, S, 3) nm member-spot
    coordinates with member_ok (G, S); init_centers (H, 3).

    E-step = generate_score_metrics + generate_scores + summarize_score
    (decode.py:1900-2070); M-step = assign_spot_groups_2_homologs
    (:1598-1662); loop = iterative_assign_spot_groups_2_homologs
    (:951-1023).
    """
    g = centroids.shape[0]
    h = init_centers.shape[0]
    dev = centroids.device
    w = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    rows = torch.arange(g, device=dev)
    region_index = region_index.to(torch.int64)
    chr_nb = _chr_tree_nb_dists(centroids, valid, n_neighbors)     # (G,)
    basic = torch.stack([mean_intensity, cv_intensity, internal_dists],
                        dim=1)                                     # (G, 3)
    valid_h = valid.repeat_interleave(h)
    n_valid = valid.sum().clamp_min(1)
    diff_th = torch.tensor(flag_diff_th, dtype=torch.float32, device=dev)

    def e_step(centers, trace, trace_valid):
        nb = _trace_nb_dists(centroids, trace, trace_valid, chr_nb,
                             n_neighbors)                          # (G, H)
        ct = torch.linalg.norm(centroids[:, None] - centers[None], dim=-1)
        metrics = torch.cat([basic[:, None, :].expand(g, h, 3),
                             nb[..., None], ct[..., None]], dim=-1)
        finals = score_groups(metrics, valid, n_spots, w)
        return torch.where(valid[:, None], finals, -_INF)

    def m_step(finals, centers):
        pref_score, _ = finals.max(dim=1)
        pref = finals.argmax(dim=1)                                # (G,)
        # per (region, homolog): the best-scoring group among those
        # preferring h; ties go to the lowest group index (the reference's
        # sequential strict-improvement walk)
        cell = region_index * h + pref
        elig = valid & (pref_score > -_INF)
        cell_score = torch.full((n_regions * h,), -_INF,
                                device=dev).scatter_reduce(
            0, cell, torch.where(elig, pref_score, -_INF), "amax")
        win = elig & (pref_score == cell_score[cell])
        cell_best = torch.full((n_regions * h,), g, dtype=torch.int64,
                               device=dev).scatter_reduce(
            0, cell, torch.where(win, rows, g), "amin")
        cell_best = torch.where(cell_best == g, -1, cell_best)
        cell_score = cell_score.reshape(n_regions, h)
        cell_best = cell_best.reshape(n_regions, h)
        # population percentile threshold (decode.py:1602-1609)
        score_th = _percentile_linear(finals.reshape(-1), valid_h,
                                      score_th_percentile)
        won = torch.isfinite(cell_score) & (cell_score >= score_th)
        sel = torch.where(won, cell_best, -1)                       # (R, H)
        # flags (collect_homolog_flags :1352-1359)
        winner_of = cell_best[region_index, pref]
        flags = torch.where(valid & (winner_of == rows)
                            & won[region_index, pref], pref, -1)
        # trace: winner centroids (tuple_list_to_zxys :1361-1370)
        trace = torch.where(won[..., None],
                            centroids[sel.clamp(0, g - 1)], _NAN)
        # centers: median of flagged centroids
        # (calculate_homolog_centroids :1375-1382)
        new_centers = torch.stack([
            torch.where((flags == hh).any(), _nanmedian_rows(torch.where(
                (flags == hh)[:, None], centroids, _NAN)), centers[hh])
            for hh in range(h)])
        return (flags, new_centers, trace.transpose(0, 1), won.T, sel.T,
                finals, score_th)

    it = 0
    diff = torch.ones((), device=dev)
    flags = torch.full((g,), -1, dtype=torch.int64, device=dev)
    centers = init_centers.to(torch.float32)
    trace = torch.full((h, n_regions, 3), _NAN, device=dev)
    trace_valid = torch.zeros((h, n_regions), dtype=torch.bool, device=dev)
    sel = torch.full((h, n_regions), -1, dtype=torch.int64, device=dev)
    finals = torch.zeros((g, h), device=dev)
    score_th = torch.tensor(-_INF, device=dev)
    while it < max_iters and bool(diff >= diff_th):
        finals_new = e_step(centers, trace, trace_valid)
        new_flags, centers, trace, trace_valid, sel, finals, score_th = \
            m_step(finals_new, centers)
        diff = ((new_flags != flags) & valid).sum() / n_valid
        flags = new_flags
        it += 1
    # member-spot coordinates of the selected groups (H, R, S, 3)
    safe = sel.clamp(0, g - 1)
    mem_ok = member_ok[safe] & trace_valid[..., None]
    mem = torch.where(mem_ok[..., None], member_zxys[safe], _NAN)
    return HomologResult(zxys=trace, zxys_valid=trace_valid, sel_group=sel,
                         member_zxys=mem, member_ok=mem_ok, flags=flags,
                         final_scores=finals, score_th=score_th,
                         centers=centers, n_iters=it)


# ---------------------------------------------------------------------------
# Host front door
# ---------------------------------------------------------------------------


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def group_statistics(groups, spots: np.ndarray,
                     pixel_size_nm=(200.0, 108.0, 108.0)):
    """Per-group stats from MERFISH SpotGroups + spot rows (host NumPy):
    (centroids (G,3) nm, mean_int, cv_int, median internal dist, n_spots,
    member_coords (G,S,3) nm, member_ok (G,S)) — the basic metrics of
    generate_score_metrics (decode.py:1919-1925)."""
    px = np.asarray(pixel_size_nm, np.float32)
    idx = _np(groups.spot_idx)
    member_ok = idx >= 0
    safe = np.clip(idx, 0, None)
    coords = np.where(member_ok[..., None], spots[safe, 1:4] * px, np.nan)
    ints = np.where(member_ok, spots[safe, 0], np.nan)
    # padding rows (no members) reduce over empty slices: NaN by design
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        centroids = np.nanmean(coords, axis=1)
        mean_int = np.nanmean(ints, axis=1)
        std_int = np.nanstd(ints, axis=1)
    cv_int = np.where(mean_int > 0, std_int / np.maximum(mean_int, 1e-9),
                      0.0)
    # median pairwise internal distance, vectorized over (G, S, S)
    d = np.linalg.norm(coords[:, :, None] - coords[:, None, :], axis=-1)
    s = idx.shape[1]
    iu, ju = np.triu_indices(s, 1)
    pair_ok = member_ok[:, iu] & member_ok[:, ju]
    vals = np.where(pair_ok, d[:, iu, ju], np.nan)
    has_pair = pair_ok.any(axis=1)       # ok=False padding rows have none
    d_int = np.zeros(len(vals))
    if has_pair.any():
        with np.errstate(invalid="ignore"):
            d_int[has_pair] = np.nanmedian(vals[has_pair], axis=1)
    d_int = np.nan_to_num(d_int, nan=0.0)
    n_spots = member_ok.sum(1).astype(np.int32)
    return (centroids, np.nan_to_num(mean_int).astype(np.float32),
            cv_int.astype(np.float32), d_int.astype(np.float32), n_spots,
            np.nan_to_num(coords, nan=0.0).astype(np.float32), member_ok)


def decode_chromosome_homologs(groups, spots: np.ndarray,
                               region_ids_of_groups: np.ndarray,
                               pixel_size_nm=(200.0, 108.0, 108.0),
                               n_homologs: int = 2, device=None,
                               **assign_kwargs) -> HomologResult:
    """Host front door: MERFISH SpotGroups (one chromosome) -> homolog
    traces (reference batch_decode_BB_like, decode.py:2139-2199).

    `groups`: decode.merfish.SpotGroups (tensors or arrays); `spots`:
    (N, 11) candidate rows; `region_ids_of_groups`: region id per group
    row.  n_homologs == 2 initializes with the BB pair program; other
    counts use k-means (reference initial_assign_homologs_by_chr).  Runs on
    `device` (the CUDA card when None).
    """
    dev = resolve_device(device)
    (centroids, mean_int, cv_int, d_int, n_spots, member_coords,
     member_ok) = group_statistics(groups, spots, pixel_size_nm)
    ok = _np(groups.ok)
    rid = _np(region_ids_of_groups)
    uniq = np.unique(rid[ok]) if ok.any() else np.zeros(1, int)
    rindex = np.clip(np.searchsorted(uniq, rid), 0, max(len(uniq) - 1, 0))

    valid = ok & np.isfinite(centroids).all(1)

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    cent = t(np.nan_to_num(centroids), torch.float32)
    valid_t = t(valid)
    if n_homologs == 2:
        c1, c2 = init_homolog_centers(cent, t(rindex), valid_t)
        init_centers = torch.stack([c1, c2])
    else:
        init_centers = t(init_centers_kmeans(centroids, valid, n_homologs))
    return assign_groups_to_homologs(
        cent, t(mean_int), t(cv_int), t(d_int), t(rindex), t(n_spots),
        valid_t, t(member_coords), t(member_ok), init_centers,
        n_regions=len(uniq), **assign_kwargs)
