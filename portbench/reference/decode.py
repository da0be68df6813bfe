"""The DNA-MERFISH decode of the plain reference: a field of view's
candidate spots -> decoded spot groups -> each chromosome's homolog traces.

A copy of the port's decode path (imageanalysis3_tpu_torch/decode/:
``DNAMerfishDecoder.decode``, ``MerfishDecoder.decode``,
``decode_chromosome_homologs`` and ``codebook_dataframe_to_tables``), the
behaviour of ImageAnalysis3's ``batch_decode_BB_like`` ->
``DNA_Merfish_Decoder`` (classes/decode.py:694-2199).  Frozen at the port's
commit f1f17c2; edit only to fix the reference.  Departures from the copy:

- no spot or group buckets: the candidate table and each chromosome's
  groups are used at their own sizes (the port pads both with invalid
  rows, which change no output);
- the greedy pair selection is the reference's sequential walk
  (decode.py:420-430) on the host: valid pairs by descending score, ties
  by pair index, a pair kept when both its spots are still unused.  The
  port's rounds of pairs best-ranked at both ends select the same pairs;
- the chromosomes are decoded one after another (the JAX package batches
  them; the port loops as this file does);
- two homologs only (the "BB" initialisation); the k-means start of other
  homolog counts is left out.

Imports neither JAX nor the port.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

_INF = float("inf")
_NAN = float("nan")
DEFAULT_METRIC_WEIGHTS = (1.0, 1.0, 1.0, 1.0, 1.0)   # decode.py:709
N_NEIGHBORS = 10                                      # decode.py:1901
_GREATER_FLAGS = (True, False, False, False, False)   # decode.py:2030
META_COLUMNS = ("name", "id", "chr", "chr_order")


# ---------------------------------------------------------------------------
# Codebook
# ---------------------------------------------------------------------------


class Codebook(NamedTuple):
    matrix: np.ndarray        # (G, B) 0/1 on-bits
    ids: np.ndarray           # (G,) region ids
    bit_values: np.ndarray    # (B,) bit labels
    pair_region: np.ndarray   # (B, B) region of a bit pair, -1 none
    chrs: np.ndarray          # (G,) chromosome of each region


def codebook_tables(columns: Mapping) -> Codebook:
    """Columns (``id``, ``chr``, one a bit) -> the codebook's tables: every
    column not a meta column is a bit, labelled by its integer name; the
    first code of a bit pair names it (decode.py:177-205)."""
    names = list(columns.keys())
    meta = {m.lower() for m in META_COLUMNS}
    bit_cols = [c for c in names if str(c).lower() not in meta]
    matrix = (np.stack([np.asarray(columns[c]) for c in bit_cols], axis=1)
              > 0).astype(np.int8)
    ids = np.asarray(columns["id"], np.int64)
    bit_values = np.array([int(c) for c in bit_cols], np.int64)
    b = matrix.shape[1]
    pair_region = np.full((b, b), -1, np.int32)
    for gi in range(matrix.shape[0]):
        on = np.flatnonzero(matrix[gi])
        for i in range(len(on)):
            for j in range(i + 1, len(on)):
                if pair_region[on[i], on[j]] < 0:
                    pair_region[on[i], on[j]] = ids[gi]
                    pair_region[on[j], on[i]] = ids[gi]
    return Codebook(matrix, ids, bit_values, pair_region,
                    np.asarray(columns["chr"]).astype(str))


# ---------------------------------------------------------------------------
# Spot groups: pair search, greedy selection, tuple completion
# ---------------------------------------------------------------------------


class Groups(NamedTuple):
    spot_idx: torch.Tensor    # (P, T) int64, -1 padded
    region: torch.Tensor      # (P,) region id, -1 for unused rows
    ok: torch.Tensor          # (P,) bool
    usage: torch.Tensor       # (N,) int32


def find_neighbors(positions: torch.Tensor, valid: torch.Tensor,
                   radius: float, k: int = 24, block: int = 1024
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each spot's up-to-k nearest other valid spots (ascending squared
    distance |a|^2 + |b|^2 - 2ab, ties by index) and whether each lies
    within `radius`."""
    n = positions.shape[0]
    k = min(k, max(n - 1, 1))
    pos = torch.where(valid[:, None], positions, 1e9)
    sq = (pos * pos).sum(dim=1)
    cols = torch.arange(n, device=pos.device)
    idx_out, ok_out = [], []
    for start in range(0, n, block):
        a = pos[start:start + block]
        dot = (a[:, None, 0] * pos[None, :, 0] + a[:, None, 1] * pos[None, :, 1]
               + a[:, None, 2] * pos[None, :, 2])
        d2 = sq[start:start + block, None] + sq[None, :] - 2.0 * dot
        rows = cols[start:start + block]
        d2 = torch.where(rows[:, None] == cols[None, :], _INF, d2)
        d2 = torch.where(valid[None, :], d2, _INF)
        _, idx = torch.topk(d2, k, dim=1, largest=False, sorted=False)
        idx = torch.sort(idx, dim=1).values
        order = torch.sort(d2.gather(1, idx), dim=1, stable=True).indices
        idx = idx.gather(1, order)
        idx_out.append(idx)
        ok_out.append(d2.gather(1, idx) <= radius * radius)
    return torch.cat(idx_out), torch.cat(ok_out) & valid[:, None]


def _empirical_cdf(values: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    n_ok = ok.sum().clamp_min(1)
    s = torch.sort(torch.where(ok, values, _INF)).values
    ranks = torch.searchsorted(s, values.contiguous(), right=True)
    return (ranks.to(torch.float32) / n_ok).clamp(1e-4, 1.0)


def select_groups(spots: torch.Tensor, positions: torch.Tensor,
                  valid: torch.Tensor, bit_index: torch.Tensor,
                  cb: Codebook, search_th: float,
                  k_neighbors: int = 24) -> Groups:
    """Candidate pairs within `search_th` nm whose bit pair names a
    region, scored by the population CDFs of their mean intensity and
    distance (decode.py:1900-2043), selected greedily without sharing a
    spot, then completed with each code's missing on-bits."""
    dev = spots.device
    n = spots.shape[0]
    nb_idx, nb_ok = find_neighbors(positions, valid, search_th,
                                   k=k_neighbors)
    k = nb_idx.shape[1]
    i = torch.arange(n, device=dev).repeat_interleave(k)
    j = nb_idx.reshape(-1)
    pair_region = torch.as_tensor(cb.pair_region, device=dev)
    ok = nb_ok.reshape(-1) & (j > i)
    region = pair_region[bit_index[i], bit_index[j]]
    ok = ok & (region >= 0)
    ints = spots[:, 0]
    mean_int = 0.5 * (ints[i] + ints[j])
    d = torch.linalg.norm(positions[i] - positions[j], dim=1)
    score = (torch.log(_empirical_cdf(mean_int, ok))
             + torch.log1p(-_empirical_cdf(d, ok).clamp(0.0, 1.0 - 1e-4)))
    score = torch.where(ok, score, -_INF)

    # the sequential best-first walk
    order = torch.argsort(-score, stable=True).cpu().numpy()
    ok_h = ok.cpu().numpy()
    ii, jj = i.cpu().numpy(), j.cpu().numpy()
    reg_h = region.cpu().numpy()
    used = np.zeros(n, bool)
    kept = []
    for p in order:
        if not ok_h[p]:
            continue
        a, b = ii[p], jj[p]
        if used[a] or used[b]:
            continue
        used[a] = used[b] = True
        kept.append(p)
    cap = max(1, n // 2)
    rows = np.full((cap, 2), -1, np.int64)
    regs = np.full(cap, -1, np.int64)
    for r, p in enumerate(kept[:cap]):
        rows[r] = (ii[p], jj[p])
        regs[r] = reg_h[p]
    got = torch.as_tensor(np.arange(cap) < min(len(kept), cap), device=dev)
    usage = torch.as_tensor(used.astype(np.int32), device=dev)
    groups = Groups(torch.as_tensor(rows, device=dev),
                    torch.as_tensor(regs, dtype=torch.int32, device=dev),
                    got, usage)
    return _complete(groups, nb_idx, nb_ok, bit_index, cb, positions)


def _complete(groups: Groups, nb_idx, nb_ok, bit_index, cb: Codebook,
              positions, max_usage: int = 1_000_000) -> Groups:
    """Each selected pair upgraded with its code's missing on-bits, in
    rounds: per group the nearest-to-centroid unused neighbour of a member
    carrying a missing bit; a spot claimed by several groups in one round
    goes to the nearest claim, then the lowest group index
    (decode.py:462-517)."""
    dev = positions.device
    max_t = int(cb.matrix.sum(1).max())
    region_bits = np.zeros((int(cb.ids.max()) + 1, cb.matrix.shape[1]),
                           np.int8)
    for gi, rid in enumerate(cb.ids):
        region_bits[rid] = cb.matrix[gi]
    region_bits = torch.as_tensor(region_bits, device=dev)
    p, t_cap = groups.spot_idx.shape
    spot_idx = torch.cat([groups.spot_idx, torch.full(
        (p, max_t - t_cap), -1, dtype=torch.int64, device=dev)], dim=1)
    usage = groups.usage.clone()
    n = nb_idx.shape[0]
    rows = torch.arange(p, device=dev)
    reg = groups.region.clamp(0, region_bits.shape[0] - 1).long()
    for _ in range(max_t - 2):
        mem = spot_idx.clamp(0, n - 1)
        mem_ok = spot_idx >= 0
        cand = nb_idx[mem].reshape(p, -1)
        cand_ok = (nb_ok[mem] & mem_ok[..., None]).reshape(p, -1)
        have = torch.zeros((p, region_bits.shape[1]), dtype=torch.int32,
                           device=dev)
        have.scatter_reduce_(1, bit_index[mem], mem_ok.to(torch.int32),
                             "amax")
        needed = (region_bits[reg] > 0) & (have == 0)
        good = (cand_ok & needed.gather(1, bit_index[cand])
                & (usage[cand] < max_usage)
                & ~(cand[:, :, None] == spot_idx[:, None, :]).any(dim=2)
                & groups.ok[:, None])
        cnt = mem_ok.sum(dim=1, keepdim=True).clamp_min(1)
        centroid = torch.where(mem_ok[..., None], positions[mem],
                               0.0).sum(dim=1) / cnt
        d = torch.linalg.norm(positions[cand] - centroid[:, None], dim=-1)
        d = torch.where(good, d, _INF)
        best = d.argmin(dim=1)
        best_d = d.gather(1, best[:, None])[:, 0]
        new_spot = cand[rows, best]
        slot = mem_ok.sum(dim=1)
        can_add = torch.isfinite(best_d) & (slot < max_t)
        tgt = torch.where(can_add, new_spot, 0)
        seg_d = torch.full((n,), _INF, device=dev).scatter_reduce(
            0, tgt, torch.where(can_add, best_d, _INF), "amin")
        is_best = can_add & (best_d <= seg_d[new_spot])
        seg_g = torch.full((n,), p, dtype=torch.int64, device=dev) \
            .scatter_reduce(0, tgt, torch.where(is_best, rows, p), "amin")
        can_add = is_best & (seg_g[new_spot] == rows)
        col = slot.clamp(0, max_t - 1)
        spot_idx[rows, col] = torch.where(can_add, new_spot,
                                          spot_idx[rows, col])
        usage.index_add_(0, tgt, can_add.to(torch.int32))
        if not bool(can_add.any()):
            break
    return Groups(spot_idx, groups.region, groups.ok, usage)


# ---------------------------------------------------------------------------
# Homolog assignment
# ---------------------------------------------------------------------------


def _pairwise(c: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(c[:, None] - c[None], dim=-1)


def _rank_cdf(values, ok, bigger_is_better: bool):
    v = values if bigger_is_better else -values
    n_ok = ok.sum().clamp_min(1)
    s = torch.sort(torch.where(ok, v, _INF)).values
    ranks = torch.searchsorted(s, v.contiguous(), right=True)
    return (ranks.to(torch.float32) / n_ok).clamp(1e-4, 1.0)


def init_centers(centroids: torch.Tensor, region_index: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """The "BB" start (decode.py:2079-2138): of every pair of group
    centroids as the two centres, groups split to the nearer; the pair of
    best rank(regions covered on both sides) x rank(-mean distance to the
    own centre) wins."""
    g = centroids.shape[0]
    dev = centroids.device
    d = _pairwise(centroids)
    d = torch.where(valid[None, :] & valid[:, None], d, 0.0)
    side2 = d[:, None, :] > d[None, :, :]
    okk = valid[None, None, :]
    s1, s2 = ~side2 & okk, side2 & okk
    n2 = s2.sum(dim=-1).clamp_min(1)
    n1 = s1.sum(dim=-1).clamp_min(1)
    rg = (torch.where(s1, d[:, None, :], 0.0).sum(-1) / n1
          + torch.where(s2, d[None, :, :], 0.0).sum(-1) / n2)
    rid = region_index.to(torch.int64)
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
    score = torch.where(flat_ok,
                        _rank_cdf(rg.reshape(-1), flat_ok, False)
                        * _rank_cdf(cov.reshape(-1), flat_ok, True), -_INF)
    best = torch.argmax(score)
    return torch.stack([centroids[best // g], centroids[best % g]])


def _mean_nearest(d: torch.Tensor, k: int) -> torch.Tensor:
    return torch.topk(d, k, dim=-1, largest=False).values.mean(dim=-1)


def _cdf_weak(values, refs_sorted, n_refs, greater: bool):
    count = torch.searchsorted(refs_sorted,
                               torch.nan_to_num(values, nan=0.0).contiguous(),
                               right=True).to(torch.float32)
    n = n_refs.to(torch.float32).clamp_min(1.0)
    cdf = count / n + 0.5 / n if greater else 1.0 - count / n + 0.5 / n
    return torch.where(torch.isnan(values), _NAN, cdf)


def _percentile_linear(values, ok, pct: float):
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
    nan = torch.isnan(x)
    s = torch.sort(torch.where(nan, _INF, x), dim=0).values
    cnt = (~nan).sum(dim=0)
    lo = ((cnt - 1) // 2).clamp_min(0)
    hi = (cnt // 2).clamp_min(0)
    a = s.gather(0, lo[None])[0]
    b = s.gather(0, hi[None])[0]
    return torch.where(cnt > 0, 0.5 * a + 0.5 * b, _NAN)


class Traces(NamedTuple):
    regions: np.ndarray        # (R,) region ids of the chromosome's groups
    zxys: np.ndarray           # (H, R, 3) nm, NaN where not assigned
    assigned: np.ndarray       # (H, R) bool


def assign_homologs(centroids, mean_int, cv_int, d_int, region_index,
                    n_spots, valid, init, n_regions: int,
                    max_iters: int = 10, flag_diff_th: float = 0.005,
                    score_th_percentile: float = 1.0):
    """The E/M loop (decode.py:951-1023, 1598-1662, 1900-2070): score each
    (group, homolog) on intensity, its spread, internal distance, the
    distance to the homolog's trace and to its centre; each region's best
    group preferring a homolog above the 1st percentile wins it; the
    centres move to the median of their groups; until fewer than 0.5 % of
    the groups change homolog, at most 10 times.  Returns the (H, R, 3)
    trace and its (H, R) mask."""
    g = centroids.shape[0]
    h = init.shape[0]
    dev = centroids.device
    w = torch.as_tensor(DEFAULT_METRIC_WEIGHTS, dtype=torch.float32,
                        device=dev)
    rows = torch.arange(g, device=dev)
    region_index = region_index.to(torch.int64)
    dc = torch.where(valid[None, :], _pairwise(centroids), _INF)
    chr_nb = torch.where(valid.sum() >= N_NEIGHBORS,
                         _mean_nearest(dc, min(N_NEIGHBORS, g)), _NAN)
    basic = torch.stack([mean_int, cv_int, d_int], dim=1)
    valid_h = valid.repeat_interleave(h)
    n_valid = valid.sum().clamp_min(1)

    def e_step(centers, trace, trace_valid):
        d = torch.linalg.norm(centroids[None, :, None] - trace[:, None, :],
                              dim=-1)
        d = torch.where(trace_valid[:, None, :], d, _INF)
        mean_k = _mean_nearest(d, min(N_NEIGHBORS, trace.shape[1]))
        nv = trace_valid.sum(dim=1)
        per_h = torch.where(nv[:, None] >= N_NEIGHBORS, mean_k, _NAN)
        nb = torch.where(nv[:, None] == 0, chr_nb[None, :], per_h).T
        ct = torch.linalg.norm(centroids[:, None] - centers[None], dim=-1)
        metrics = torch.cat([basic[:, None, :].expand(g, h, 3),
                             nb[..., None], ct[..., None]], dim=-1)
        flat_ok = valid.repeat_interleave(h)
        n_refs = flat_ok.sum()
        finals = torch.zeros((g, h), dtype=torch.float32, device=dev)
        for i in range(metrics.shape[2]):
            vals = metrics[:, :, i]
            refs = torch.where(flat_ok, vals.reshape(-1), _NAN)
            refs_sorted = torch.sort(torch.nan_to_num(refs, nan=_INF)).values
            cdf = _cdf_weak(vals, refs_sorted, n_refs, _GREATER_FLAGS[i])
            finals = finals + torch.nan_to_num(w[i] * torch.log(cdf),
                                               nan=0.0)
        finals = finals / n_spots.clamp_min(1)[:, None].to(torch.float32)
        return torch.where(valid[:, None], finals, -_INF)

    def m_step(finals, centers):
        pref_score, _ = finals.max(dim=1)
        pref = finals.argmax(dim=1)
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
        score_th = _percentile_linear(finals.reshape(-1), valid_h,
                                      score_th_percentile)
        won = torch.isfinite(cell_score) & (cell_score >= score_th)
        sel = torch.where(won, cell_best, -1)
        winner_of = cell_best[region_index, pref]
        flags = torch.where(valid & (winner_of == rows)
                            & won[region_index, pref], pref, -1)
        trace = torch.where(won[..., None],
                            centroids[sel.clamp(0, g - 1)], _NAN)
        new_centers = torch.stack([
            torch.where((flags == hh).any(), _nanmedian_rows(torch.where(
                (flags == hh)[:, None], centroids, _NAN)), centers[hh])
            for hh in range(h)])
        return flags, new_centers, trace.transpose(0, 1), won.T

    it = 0
    diff = torch.ones((), device=dev)
    flags = torch.full((g,), -1, dtype=torch.int64, device=dev)
    centers = init.to(torch.float32)
    trace = torch.full((h, n_regions, 3), _NAN, device=dev)
    trace_valid = torch.zeros((h, n_regions), dtype=torch.bool, device=dev)
    while it < max_iters and bool(diff >= flag_diff_th):
        finals = e_step(centers, trace, trace_valid)
        new_flags, centers, trace, trace_valid = m_step(finals, centers)
        diff = ((new_flags != flags) & valid).sum() / n_valid
        flags = new_flags
        it += 1
    return trace, trace_valid


def group_statistics(spot_idx: np.ndarray, spots: np.ndarray,
                     pixel_size_nm: np.ndarray):
    """Each group's centroid (nm), mean intensity, its coefficient of
    variation, median internal distance (nm) and member count
    (decode.py:1919-1925)."""
    member = spot_idx >= 0
    safe = np.clip(spot_idx, 0, None)
    coords = np.where(member[..., None], spots[safe, 1:4] * pixel_size_nm,
                      np.nan)
    ints = np.where(member, spots[safe, 0], np.nan)
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        centroids = np.nanmean(coords, axis=1)
        mean_int = np.nanmean(ints, axis=1)
        std_int = np.nanstd(ints, axis=1)
    cv_int = np.where(mean_int > 0, std_int / np.maximum(mean_int, 1e-9),
                      0.0)
    d = np.linalg.norm(coords[:, :, None] - coords[:, None, :], axis=-1)
    iu, ju = np.triu_indices(spot_idx.shape[1], 1)
    pair_ok = member[:, iu] & member[:, ju]
    vals = np.where(pair_ok, d[:, iu, ju], np.nan)
    has_pair = pair_ok.any(axis=1)
    d_int = np.zeros(len(vals))
    if has_pair.any():
        with np.errstate(invalid="ignore"):
            d_int[has_pair] = np.nanmedian(vals[has_pair], axis=1)
    return (centroids, np.nan_to_num(mean_int).astype(np.float32),
            cv_int.astype(np.float32),
            np.nan_to_num(d_int, nan=0.0).astype(np.float32),
            member.sum(1).astype(np.int32))


def chromosome_traces(spot_idx: np.ndarray, regions: np.ndarray,
                      spots: np.ndarray, pixel_size_nm: np.ndarray,
                      device) -> Traces:
    """One chromosome's decoded groups -> its two homolog traces."""
    centroids, mean_int, cv_int, d_int, n_spots = group_statistics(
        spot_idx, spots, pixel_size_nm)
    uniq = np.unique(regions)
    rindex = np.searchsorted(uniq, regions)
    valid = np.isfinite(centroids).all(1)

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    cent = t(np.nan_to_num(centroids), torch.float32)
    init = init_centers(cent, t(rindex), t(valid))
    trace, ok = assign_homologs(cent, t(mean_int), t(cv_int), t(d_int),
                                t(rindex), t(n_spots), t(valid), init,
                                n_regions=len(uniq))
    return Traces(uniq, trace.cpu().numpy(), ok.cpu().numpy())


class Decoded(NamedTuple):
    groups: List[Tuple[int, Tuple[int, ...]]]   # (region, sorted spot ids)
    traces: Dict[str, Traces]


def decode_fov(spots: np.ndarray, bits: np.ndarray, codebook: Mapping,
               pixel_size_nm, search_th: float = 250.0,
               num_homologs: int = 2, keep_ratio_th: float = 0.2,
               device="cpu") -> Optional[Decoded]:
    """A field of view's candidate spots ((N, 11) rows, positions in px)
    and their 1-based codebook bits -> the decoded groups and each
    chromosome's homolog traces; None when fewer candidates than
    `keep_ratio_th` of the code's spots (decode.py:2158-2160)."""
    if num_homologs != 2:
        raise ValueError("the reference decodes two homologs only")
    cb = codebook_tables(codebook)
    spots = np.asarray(spots, np.float32)
    if len(spots) < num_homologs * cb.matrix.sum() * keep_ratio_th:
        return None
    px = np.asarray(pixel_size_nm, np.float32)
    dev = torch.device(device)
    spots_t = torch.as_tensor(spots, device=dev)
    positions = spots_t[:, 1:4] * torch.as_tensor(px, device=dev)[None]
    lut = {int(b): i for i, b in enumerate(cb.bit_values)}
    bit_index = torch.as_tensor(np.array([lut[int(b)] for b in bits],
                                         np.int64), device=dev)
    valid = torch.ones(len(spots), dtype=torch.bool, device=dev)
    g = select_groups(spots_t, positions, valid, bit_index, cb, search_th)
    ok = g.ok.cpu().numpy()
    spot_idx = g.spot_idx.cpu().numpy()[ok]
    regions = g.region.cpu().numpy()[ok].astype(np.int64)
    groups = [(int(r), tuple(sorted(int(s) for s in row if s >= 0)))
              for r, row in zip(regions, spot_idx)]
    chr_of = dict(zip(cb.ids.tolist(), cb.chrs.tolist()))
    traces = {}
    for name in sorted(set(cb.chrs.tolist())):
        sel = np.array([chr_of[int(r)] == name for r in regions], bool)
        if int(sel.sum()) < 2 * num_homologs:
            continue
        traces[name] = chromosome_traces(spot_idx[sel], regions[sel], spots,
                                         px, dev)
    return Decoded(groups, traces)
