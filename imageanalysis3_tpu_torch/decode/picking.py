"""Spot picking: per-region candidate spots -> per-chromosome traces.

The counterpart of ``imageanalysis3_tpu/decode/picking.py``.  Behavior
targets (reference spot_tools/picking.py): the naive picker (:14,
:797-901), the dynamic-programming picker (:902-1203), the EM picker
(:1204-1530), candidate merging and chromosome assignment (:662-795).

Candidates are a dense (R, M, 11) table indexed by sorted region id with
validity masks.  The JAX package's ``lax.scan`` DP becomes a loop over
regions whose carry is the (M,) frontier (each step an (M, M) distance
block and a max-reduce; empty regions pass the frontier through), with no
host read inside it.  Its ``while_loop`` EMs become loops with one host
read of the stop condition per iteration.  Several chromosomes run as one
batch through every step (a leading (C,) dim where the JAX package
vmaps): with shared spots each chromosome stops at its own iteration,
frozen by ``torch.where``, as the vmapped ``while_loop`` does; with
exclusive spots they iterate together.

The entry points (``naive_pick_spots``, ``em_pick_spots``,
``em_pick_spots_for_chromosomes``, ``em_pick_spots_exclusive``,
``merge_spot_lists``, ``assign_spots_to_chromosomes``) take ``device``:
the CUDA card unless ``device="cpu"``; tensors stay where they are.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT_PIXEL_SIZE_NM
from ..device import as_tensor, resolve_device
from ..ops.filters import nanquantile
from .scoring import (chromosome_ref_stats, linear_distance_score, norm,
                      pixel_sizes, score_candidates)


def _naive_scores(cand_spots, cand_valid, chrom_center, pixel_size_nm,
                  w_int=1.0, w_ctdist=1.0, use_center_dist=True):
    """(..., R, M) naive scores: log intensity ratio - log center-dist
    ratio; `chrom_center` (..., 3) px or None."""
    heights = cand_spots[..., 0]
    if chrom_center is not None and use_center_dist:
        px = pixel_sizes(pixel_size_nm, cand_spots.device)
        d = norm(cand_spots[..., 1:4] * px
                 - (chrom_center * px)[..., None, None, :])
        nan = float("nan")
        med_d = nanquantile(torch.where(cand_valid, d, nan), 0.5, (-2, -1))
        med_h = nanquantile(torch.where(cand_valid, heights, nan), 0.5,
                            (-2, -1))
        score = (w_int * torch.log(heights.clamp_min(1e-6)
                                   / med_h.clamp_min(1e-6)[..., None, None])
                 - w_ctdist * torch.log(
                     d.clamp_min(1e-6)
                     / med_d.clamp_min(1e-6)[..., None, None]))
    else:
        score = heights
    return torch.where(cand_valid, score, float("-inf"))


def _center(chrom_center, dev) -> Optional[torch.Tensor]:
    return (None if chrom_center is None
            else as_tensor(chrom_center, dev).to(torch.float32))


def naive_pick_spots(cand_spots, cand_valid, chrom_center=None,
                     pixel_size_nm=DEFAULT_PIXEL_SIZE_NM,
                     w_int: float = 1.0, w_ctdist: float = 1.0,
                     use_center_dist: bool = True, device=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pick one spot per region -> (trace (R, 11), picked mask (R,)).

    Score = w_int * log(h / median_h) - w_ctdist * log(dist_to_center /
    median_dist); highest-scoring valid candidate wins (the naive scoring of
    reference spot_tools/picking.py:797-901 simplified to its intensity +
    center-distance core).  Regions with no valid candidates return NaN rows.
    """
    dev = resolve_device(device)
    cand_spots, cand_valid = as_tensor(cand_spots, dev), as_tensor(
        cand_valid, dev)
    score = _naive_scores(cand_spots, cand_valid, _center(chrom_center, dev),
                          pixel_size_nm, w_int, w_ctdist, use_center_dist)
    best = score.argmax(dim=1)
    picked = cand_spots[torch.arange(len(best), device=best.device), best]
    has = cand_valid.any(dim=1)
    return torch.where(has[:, None], picked, float("nan")), has


def take_trace(cand_spots: torch.Tensor, cand_valid: torch.Tensor,
               sel_idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather the (..., R, 11) trace selected by per-region indices
    (..., R); rows whose pick is not a valid candidate become NaN."""
    r = cand_spots.shape[0]
    picked = cand_spots[torch.arange(r, device=sel_idx.device), sel_idx]
    valid = cand_valid.expand(*sel_idx.shape, cand_valid.shape[-1])
    ok = valid.gather(-1, sel_idx[..., None])[..., 0]
    return torch.where(ok[..., None], picked, float("nan")), ok


def dynamic_pick_spots(cand_spots: torch.Tensor, cand_valid: torch.Tensor,
                       spot_scores: torch.Tensor, region_ids: torch.Tensor,
                       nb_dist_ref, pixel_size_nm=DEFAULT_PIXEL_SIZE_NM,
                       w_nbdist: float = 2.0,
                       max_distance_limit: float = 3000.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Globally optimal chain of one spot per region -> (sel_idx (..., R),
    total score (...)).

    Behavior target: dynamic_pick_spots_for_chromosomes
    (spot_tools/picking.py:902-1203), single-chromosome core: maximize
    sum_i [spot_score(i, m_i)] + sum_edges [distance_score(d(m_i, m_j),
    nb_dist_ref, w_nbdist) / (id_j - id_i)].  Regions whose candidates are
    all invalid are skipped (the frontier passes through, and the id gap
    spans them), exactly like the reference dropping empty regions.
    `spot_scores` (..., R, M) and `nb_dist_ref` (...) carry a batch of
    chromosomes over the one (R, M, 11) table; `cand_valid` is (R, M) or
    batched likewise.
    """
    r, m, _ = cand_spots.shape
    dev = cand_spots.device
    px = pixel_sizes(pixel_size_nm, dev)
    zxys = cand_spots[..., 1:4] * px                        # (R, M, 3)
    valid = cand_valid.expand(spot_scores.shape)
    has_any = valid.any(dim=-1)                             # (..., R)
    scores = torch.where(valid, spot_scores, float("-inf"))
    batch = scores.shape[:-2]
    nb_ref = torch.as_tensor(nb_dist_ref, dtype=torch.float32,
                             device=dev).expand(batch)[..., None, None]
    ids_f = region_ids.to(device=dev, dtype=torch.float32)
    ar_m = torch.arange(m, device=dev)

    dy = torch.zeros(*batch, m, device=dev)
    prev_zxy = (zxys[0] * 0.0).expand(*batch, m, 3)
    prev_id = (ids_f[0] - 1.0).expand(batch)
    anchored = torch.zeros(batch, dtype=torch.bool, device=dev)
    ptrs = []
    for i in range(r):
        sc, zxy, ok_any, rid = scores[..., i, :], zxys[i], has_any[..., i], \
            ids_f[i]
        gap = (rid - prev_id).abs().clamp_min(1.0)
        d = norm(prev_zxy[..., :, None, :] - zxy)           # (..., M, M)
        nb = linear_distance_score(d, nb_ref, w_nbdist,
                                   max_distance_limit) / gap[..., None, None]
        measure = dy[..., :, None] + nb
        best_prev = measure.argmax(dim=-2)
        # the first non-empty region anchors the chain with its own scores
        dy_new = torch.where(anchored[..., None],
                             sc + measure.amax(dim=-2), sc)
        ptr = torch.where(anchored[..., None], best_prev, -1)
        # an empty region passes frontier and anchor through unchanged
        dy = torch.where(ok_any[..., None], dy_new, dy)
        prev_zxy = torch.where(ok_any[..., None, None], zxy, prev_zxy)
        prev_id = torch.where(ok_any, rid, prev_id)
        ptrs.append(torch.where(ok_any[..., None], ptr, ar_m))
        anchored = anchored | ok_any

    # walk the pointers back from the best end; -1 marks the anchor
    idx = dy.argmax(dim=-1)
    total = dy.amax(dim=-1)
    sel = [None] * r
    for i in range(r - 1, -1, -1):
        sel[i] = idx
        nxt = ptrs[i].gather(-1, idx[..., None])[..., 0]
        idx = torch.where(nxt < 0, idx, nxt)
    return torch.where(has_any, torch.stack(sel, dim=-1), 0), total


class EMPickResult(NamedTuple):
    trace: torch.Tensor       # (R, 11) picked rows (NaN where unpicked)
    sel_idx: torch.Tensor     # (R,) candidate index per region
    sel_valid: torch.Tensor   # (R,) region has a real pick
    scores: torch.Tensor      # (R,) picked spot scores
    n_iters: torch.Tensor     # () int32 EM iterations run
    change_ratio: torch.Tensor  # () f32 final change ratio
    # (C,) int32: picks hard-invalidated because a cross-chromosome
    # contest was still unresolved after n_resolve_rounds (exclusive
    # picker only).  Nonzero values mean regions came back empty that
    # more resolve rounds might have filled.
    n_unresolved: Optional[torch.Tensor] = None


class _EStep:
    """The E-step of one candidate table: (C, R) picks and (C, 3) centres
    (or None) -> (C, R, M) scores and (C,) neighbour reference."""

    def __init__(self, cand_spots, cand_valid, pixel_size_nm, local_size,
                 w_ctdist, w_lcdist, w_int, max_distance_limit):
        self.cand_spots, self.cand_valid = cand_spots, cand_valid
        self.has_any = cand_valid.any(dim=1)
        self.kw = dict(pixel_size_nm=pixel_size_nm, local_size=local_size)
        self.w = dict(w_ctdist=w_ctdist, w_lcdist=w_lcdist, w_int=w_int,
                      max_distance_limit=max_distance_limit)

    def __call__(self, sel_idx, centers):
        trace, ok = take_trace(self.cand_spots, self.cand_valid, sel_idx)
        sel_ok = ok & self.has_any
        sel = torch.where(sel_ok[..., None], trace, 0.0)
        refs = chromosome_ref_stats(sel, sel_ok, centers, **self.kw)
        sc = score_candidates(self.cand_spots, self.cand_valid, sel, sel_ok,
                              centers, refs, **self.kw, **self.w)
        nb_ref = torch.where(torch.isfinite(refs.nb_dist), refs.nb_dist,
                             500.0)
        return sc, nb_ref


def _picked_scores(sc, sel_idx, sel_valid):
    picked = sc.gather(-1, sel_idx[..., None])[..., 0]
    return torch.where(sel_valid, picked, float("nan"))


def _em_batch(cand_spots, cand_valid, region_ids, centers, n_chrom: int,
              pixel_size_nm=DEFAULT_PIXEL_SIZE_NM, num_iters: int = 10,
              terminate_th: float = 0.0025, local_size: int = 5,
              w_ctdist: float = 2.0, w_lcdist: float = 1.0,
              w_int: float = 1.0, w_nbdist: float = 2.0,
              max_distance_limit: float = 3000.0) -> EMPickResult:
    """`n_chrom` independent EMs over one table, batched: each stops at its
    own iteration (the JAX package's vmapped while_loop)."""
    r, m, _ = cand_spots.shape
    dev = cand_spots.device
    e_step = _EStep(cand_spots, cand_valid, pixel_size_nm, local_size,
                    w_ctdist, w_lcdist, w_int, max_distance_limit)
    has_any = e_step.has_any
    n_regions = has_any.sum().clamp_min(1).to(torch.float32)
    sel_idx = _naive_scores(cand_spots, cand_valid, centers,
                            pixel_size_nm).argmax(dim=-1)
    sel_idx = sel_idx.expand(n_chrom, r).clone()
    it = torch.zeros(n_chrom, dtype=torch.int32, device=dev)
    change = torch.ones(n_chrom, device=dev)
    sc = torch.zeros(n_chrom, r, m, device=dev)
    th = torch.tensor(terminate_th, dtype=torch.float32, device=dev)
    while True:
        active = (it < num_iters) & (change >= th)
        if not bool(active.any()):                  # the iteration's read
            break
        new_sc, nb_ref = e_step(sel_idx, centers)
        new_idx, _ = dynamic_pick_spots(cand_spots, cand_valid, new_sc,
                                        region_ids, nb_ref, pixel_size_nm,
                                        w_nbdist, max_distance_limit)
        changed = ((new_idx != sel_idx) & has_any).sum(dim=-1)
        ratio = changed.to(torch.float32) / n_regions
        sel_idx = torch.where(active[:, None], new_idx, sel_idx)
        sc = torch.where(active[:, None, None], new_sc, sc)
        change = torch.where(active, ratio, change)
        it = it + active.to(torch.int32)
    trace, sel_valid = take_trace(cand_spots, cand_valid, sel_idx)
    return EMPickResult(trace=trace, sel_idx=sel_idx, sel_valid=sel_valid,
                        scores=_picked_scores(sc, sel_idx, sel_valid),
                        n_iters=it, change_ratio=change)


def _table(cand_spots, cand_valid, region_ids, dev):
    return (as_tensor(cand_spots, dev).to(torch.float32),
            as_tensor(cand_valid, dev).to(torch.bool),
            as_tensor(region_ids, dev))


def em_pick_spots(cand_spots, cand_valid, region_ids, chrom_center=None,
                  pixel_size_nm=DEFAULT_PIXEL_SIZE_NM,
                  num_iters: int = 10, terminate_th: float = 0.0025,
                  local_size: int = 5,
                  w_ctdist: float = 2.0, w_lcdist: float = 1.0,
                  w_int: float = 1.0, w_nbdist: float = 2.0,
                  max_distance_limit: float = 3000.0,
                  device=None) -> EMPickResult:
    """EM spot picking for one chromosome (reference
    EM_pick_spots_for_chromosomes, spot_tools/picking.py:1204-1530).

    E-step: score candidates against the current trace's reference stats;
    M-step: dynamic-programming chain maximizing score + continuity;
    iterate until the picked set changes less than `terminate_th` or
    `num_iters` is reached.  Initialization is the naive pick.
    """
    dev = resolve_device(device)
    cand_spots, cand_valid, region_ids = _table(cand_spots, cand_valid,
                                                region_ids, dev)
    center = _center(chrom_center, dev)
    res = _em_batch(cand_spots, cand_valid, region_ids,
                    None if center is None else center[None], 1,
                    pixel_size_nm, num_iters, terminate_th, local_size,
                    w_ctdist, w_lcdist, w_int, w_nbdist, max_distance_limit)
    return EMPickResult(*(f[0] for f in res[:6]))


def em_pick_spots_for_chromosomes(cand_spots, cand_valid, region_ids,
                                  chrom_centers, share_spots: bool = True,
                                  device=None, **kw) -> EMPickResult:
    """EM picking for several chromosomes sharing one candidate table.

    ``share_spots=True`` (reference chrom_share_spots=True): independent
    EMs, batched -- two chromosomes may pick the same candidate, and each
    stops at its own iteration.  ``share_spots=False`` (the reference
    default, chrom_share_spots=False, spot_tools/picking.py:1106-1125):
    spots are exclusive -- see :func:`em_pick_spots_exclusive`.
    `chrom_centers`: (C, 3) px; returns an EMPickResult batched over
    chromosomes."""
    if not share_spots:
        return em_pick_spots_exclusive(cand_spots, cand_valid, region_ids,
                                       chrom_centers, device=device, **kw)
    dev = resolve_device(device)
    cand_spots, cand_valid, region_ids = _table(cand_spots, cand_valid,
                                                region_ids, dev)
    centers = _center(chrom_centers, dev)
    return _em_batch(cand_spots, cand_valid, region_ids, centers,
                     centers.shape[0], **kw)


def em_pick_spots_exclusive(cand_spots, cand_valid, region_ids,
                            chrom_centers,
                            pixel_size_nm=DEFAULT_PIXEL_SIZE_NM,
                            num_iters: int = 10,
                            terminate_th: float = 0.0025,
                            local_size: int = 5,
                            w_ctdist: float = 2.0, w_lcdist: float = 1.0,
                            w_int: float = 1.0, w_nbdist: float = 2.0,
                            max_distance_limit: float = 3000.0,
                            n_resolve_rounds: int = 3,
                            device=None) -> EMPickResult:
    """Joint EM picking with cross-chromosome spot exclusivity.

    Behavior target: the reference's chrom_share_spots=False multi-
    chromosome DP (spot_tools/picking.py:1106-1125).  Each EM iteration
    runs every chromosome's E-step + DP as one batch, then resolves
    contested (region, candidate) cells over `n_resolve_rounds`: the
    chromosome with the higher E-step score keeps the spot, losers re-run
    their DP with that cell banned.  Any contest still unresolved after
    the rounds invalidates the losers' picks for that region (never
    double-assigns).  Returns an EMPickResult batched over chromosomes.
    """
    dev = resolve_device(device)
    cand_spots, cand_valid, region_ids = _table(cand_spots, cand_valid,
                                                region_ids, dev)
    centers = _center(chrom_centers, dev)
    c = centers.shape[0]
    r, m, _ = cand_spots.shape
    e_step = _EStep(cand_spots, cand_valid, pixel_size_nm, local_size,
                    w_ctdist, w_lcdist, w_int, max_distance_limit)
    has_any = e_step.has_any
    n_regions = max(int(has_any.sum()), 1)
    ar_m = torch.arange(m, device=dev)
    ar_c = torch.arange(c, device=dev)[:, None, None]

    def dp(sc, nb_ref, avail):
        ok = cand_valid & avail
        return dynamic_pick_spots(cand_spots, ok,
                                  torch.where(ok, sc, float("-inf")),
                                  region_ids, nb_ref, pixel_size_nm,
                                  w_nbdist, max_distance_limit)[0]

    def contests(sc, idx, avail):
        """(picked_ok (C, R), losers (C, R, M)): the cells two or more
        chromosomes picked, less each cell's best-scoring picker."""
        picked_ok = (cand_valid & avail).gather(-1, idx[..., None])[..., 0]
        onehot = (ar_m == idx[..., None]) & picked_ok[..., None]
        counts = onehot.sum(dim=0)
        winner = torch.where(onehot, sc, float("-inf")).argmax(dim=0)
        return picked_ok, onehot & (counts > 1) & (ar_c != winner)

    def m_step(sel_idx):
        sc, nb_ref = e_step(sel_idx, centers)               # (C, R, M)
        avail = torch.ones(c, r, m, dtype=torch.bool, device=dev)
        idx = dp(sc, nb_ref, avail)
        for _ in range(n_resolve_rounds):
            avail = avail & ~contests(sc, idx, avail)[1]
            idx = dp(sc, nb_ref, avail)
        # hard finish: any residual contest keeps only the winner
        picked_ok, residual = contests(sc, idx, avail)
        kept = (~residual).gather(-1, idx[..., None])[..., 0]
        return idx, picked_ok & kept, residual.sum(dim=(1, 2)).to(
            torch.int32)

    # init: per-chromosome naive pick (ties resolved by the first M-step)
    sel_idx = _naive_scores(cand_spots, cand_valid, centers,
                            pixel_size_nm).argmax(dim=-1)
    sel_valid = torch.zeros(c, r, dtype=torch.bool, device=dev)
    n_unresolved = torch.zeros(c, dtype=torch.int32, device=dev)
    it, change = 0, np.float32(1.0)
    while it < num_iters and change >= np.float32(terminate_th):
        new_idx, sel_valid, n_unresolved = m_step(sel_idx)
        changed = int(((new_idx != sel_idx) & has_any).sum())
        change = np.float32(changed) / np.float32(c * n_regions)
        sel_idx, it = new_idx, it + 1

    trace, ok = take_trace(cand_spots, cand_valid, sel_idx)
    ok = ok & sel_valid
    sc_final, _ = e_step(sel_idx, centers)
    return EMPickResult(
        trace=torch.where(ok[..., None], trace, float("nan")),
        sel_idx=sel_idx, sel_valid=ok,
        scores=_picked_scores(sc_final, sel_idx, ok),
        n_iters=torch.full((c,), it, dtype=torch.int32, device=dev),
        change_ratio=torch.full((c,), float(change), device=dev),
        n_unresolved=n_unresolved)


def build_candidate_table(spots_by_region, capacity: Optional[int] = None):
    """Host-side: {region_id: (n_i, 11) array} -> dense fixed-capacity
    (cand (R, M, 11) f32, valid (R, M) bool, region_ids (R,) int32) sorted
    by region id -- the layout all pickers consume.
    """
    ids = sorted(int(k) for k in spots_by_region)
    counts = [len(np.atleast_2d(spots_by_region[i]))
              if np.size(spots_by_region[i]) else 0 for i in ids]
    m = capacity or max(max(counts, default=1), 1)
    r = len(ids)
    cand = np.zeros((r, m, 11), np.float32)
    valid = np.zeros((r, m), bool)
    for j, rid in enumerate(ids):
        sp = np.atleast_2d(np.asarray(spots_by_region[rid], np.float32))
        if sp.size == 0:
            continue
        n = min(len(sp), m)
        # keep the brightest if over capacity
        if len(sp) > m:
            sp = sp[np.argsort(-sp[:, 0])[:m]]
        good = np.all(np.isfinite(sp[:n, 1:4]), axis=1)
        cand[j, :n] = sp[:n]
        valid[j, :n] = good
    return cand, valid, np.asarray(ids, np.int32)


# ---------------------------------------------------------------------------
# Candidate merging and chromosome assignment (reference picking.py:662-795)
# ---------------------------------------------------------------------------


def merge_spot_lists(spots, valid, dist_th: float = 0.1,
                     dist_norm: float = 2.0, intensity_th: float = 0.0,
                     hard_intensity_th: bool = True, n_lists: int = 1,
                     device=None) -> torch.Tensor:
    """Deduplicate concatenated candidate lists -> kept mask.

    Behavior target: reference merge_spot_list (picking.py:662-765): walk
    candidates in order; a still-kept spot removes every later spot
    within `dist_th` (pixels, `dist_norm`-norm).  The intensity screen
    runs first: hard mode drops every spot below `intensity_th`, soft
    mode keeps the top max(n_lists, #above-threshold) by intensity
    (:714-723).  The first-come walk runs in the reference's order over
    the spots that are kept at the start and have a spot within reach
    (the others drop nothing); one host read finds them.
    """
    dev = resolve_device(device)
    spots = as_tensor(spots, dev).to(torch.float32)
    valid = as_tensor(valid, dev).to(torch.bool)
    n = spots.shape[0]
    if hard_intensity_th:
        kept = valid & (spots[:, 0] >= intensity_th)
    else:
        ints = torch.where(valid, spots[:, 0], float("-inf"))
        order = torch.argsort(-ints, stable=True)
        rank = torch.empty(n, dtype=torch.int64, device=spots.device)
        rank[order] = torch.arange(n, device=spots.device)
        keep_n = (ints >= intensity_th).sum().clamp_min(n_lists)
        kept = valid & (rank < keep_n)
    diff = (spots[:, None, 1:4] - spots[None, :, 1:4]).abs()
    if dist_norm == 2.0:
        d = torch.sqrt((diff * diff).sum(dim=-1))
    else:
        d = (diff ** dist_norm).sum(dim=-1) ** (1.0 / dist_norm)
    close = (d < dist_th) & valid[:, None] & valid[None, :]
    close.fill_diagonal_(False)
    for i in torch.nonzero(kept & close.any(dim=1))[:, 0].tolist():
        kept = kept & ~(kept[i] & close[i])
    return kept


def assign_spots_to_chromosomes(spots, valid, chrom_coords,
                                pixel_size_nm=DEFAULT_PIXEL_SIZE_NM,
                                device=None) -> torch.Tensor:
    """Nearest-chromosome index per spot (int32, -1 for invalid spots).

    Behavior target: reference assign_spots_to_chromosomes
    (picking.py:767-794): both spots and chromosome centers scale from
    pixels to nm before the distance argmin.  Gather rows with
    ``spots[assignment == k]``.
    """
    dev = resolve_device(device)
    spots = as_tensor(spots, dev).to(torch.float32)
    valid = as_tensor(valid, dev).to(torch.bool)
    chrom = as_tensor(chrom_coords, dev).to(torch.float32)
    px = pixel_sizes(pixel_size_nm, spots.device)
    d = norm((spots[:, 1:4] * px)[:, None] - (chrom * px)[None])
    idx = d.argmin(dim=1).to(torch.int32)
    return torch.where(valid, idx, -1)
