"""Structure analysis: contacts, inter-domain interactions, loop-outs,
genome-wide summaries.

The counterpart of ``imageanalysis3_tpu/analysis/structure.py``.  Behavior
targets (reference ImageAnalysis3): contact maps and domain contact
frequency (domain_tools/calling.py:826-855, structure_tools/contact.py),
inter-domain interaction calling (domain_tools/interaction.py:73-600),
loop-out detection (interaction.py:602-638), genome-wide distance
summaries (structure_tools/distance.py).

The JAX module is float64 NumPy; here every array computation is float64
on the device of the distance map (NumPy input goes to `device`, default
the card).  Block statistics are one batched gather: domain contact
frequencies are sums of 0/1 entries (exact in float64), the segment
medians are ``domains._segment_distances``, and the likelihood matrix
adds each domain's row and column in the order the JAX loop does, so it
comes out symmetric and equal to the loop's sums.  The interaction
loop's bookkeeping (pair sets, thresholds) stays on the host; its
percentiles follow ``np.percentile``'s linear rule.  Pairs come back as
lists of tuples, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..decode.scoring import norm
from ..device import as_tensor, host_array
from ..ops.filters import nanquantile
from .domains import (_bounds, _distance_map, _masked_median,
                      _segment_distances)

f64 = torch.float64
_NAN = float("nan")

def _map(distmap, device) -> torch.Tensor:
    return as_tensor(distmap, device).to(f64)


def _sorted_starts(starts) -> List[int]:
    return sorted(int(s) for s in starts)


def contact_map(distmap, contact_th: float = 500.0,
                device=None) -> torch.Tensor:
    """Boolean contact map of one distance map: distance below
    `contact_th` nm (NaN is no contact)."""
    dm = _map(distmap, device)
    return (dm < contact_th) & torch.isfinite(dm)


def _segment_matrix(starts: List[int], n: int, dev) -> torch.Tensor:
    """(D, R) float64 one-hot of each region's domain."""
    seg = torch.zeros((len(starts), n), dtype=f64, device=dev)
    for k, (s, e) in enumerate(_bounds(starts, n)):
        seg[k, s:e] = 1.0
    return seg


def domain_contact_freq(distmap, starts: Sequence[int],
                        contact_th: float = 500.0,
                        device=None) -> torch.Tensor:
    """(D, D) mean contact frequency between domain blocks: contacts over
    finite entries (at least 1) of each block."""
    dm = _map(distmap, device)
    seg = _segment_matrix(_sorted_starts(starts), dm.shape[0], dm.device)
    cm = contact_map(dm, contact_th).to(f64)
    fin = torch.isfinite(dm).to(f64)
    return (seg @ cm @ seg.T) / (seg @ fin @ seg.T).clamp_min(1.0)


def inter_domain_interactions(distmap, starts: Sequence[int],
                              separation_th: float = 0.55,
                              exclude_neighbors: bool = True,
                              device=None) -> List[Tuple[int, int]]:
    """Domain pairs whose cross-block separation statistic is below
    `separation_th` (chain neighbours excluded by default)."""
    dm = _map(distmap, device)
    b = _bounds(_sorted_starts(starts), dm.shape[0])
    cand = [(i, j) for i in range(len(b)) for j in range(i + 1, len(b))
            if not (exclude_neighbors and j == i + 1)]
    sep = host_array(_segment_distances(dm, [b[i] for i, _ in cand],
                                        [b[j] for _, j in cand]))
    return [p for p, s in zip(cand, sep)
            if np.isfinite(s) and s < separation_th]


def loop_out_scores(distmap, starts: Sequence[int], window: int = 5,
                    device=None) -> torch.Tensor:
    """(R, D) separation of each region's local window (+-window//2) from
    each foreign domain; NaN for its own domain and where a sample is
    empty.  One gather of every (region, domain) block."""
    dm = _map(distmap, device)
    dev = dm.device
    r = dm.shape[0]
    st = _sorted_starts(starts)
    b = _bounds(st, r)
    half = window // 2
    a = torch.arange(2 * half + 1, device=dev)
    rows = torch.arange(r, device=dev)[:, None] - half + a[None]   # (R, W)
    row_ok = (rows >= 0) & (rows < r)
    rows = rows.clamp(0, r - 1)
    lens = torch.as_tensor([e - s for s, e in b], device=dev)
    width = int(lens.max())
    cols = torch.as_tensor([s for s, _ in b], device=dev)[:, None] \
        + torch.arange(width, device=dev)[None]                     # (D, L)
    col_ok = torch.arange(width, device=dev)[None] < lens[:, None]
    cols = cols.clamp(0, r - 1)
    inter = dm[rows[:, None, :, None], cols[None, :, None, :]]     # R,D,W,L
    inter_ok = (row_ok[:, None, :, None] & col_ok[None, :, None, :]
                & torch.isfinite(inter)).flatten(2)
    inter = inter.flatten(2)
    intra = dm[rows[:, :, None], rows[:, None, :]]                   # R,W,W
    upper = a[:, None] < a[None, :]
    intra_ok = (upper & row_ok[:, :, None] & row_ok[:, None, :]
                & torch.isfinite(intra)).flatten(1)
    intra = intra.flatten(1)
    m_i = _masked_median(intra, intra_ok)
    d_i = intra - m_i[:, None]
    v_i = _masked_median(d_i * d_i, intra_ok)
    m_o = _masked_median(inter, inter_ok)
    d_o = inter - m_o[..., None]
    v_o = _masked_median(d_o * d_o, inter_ok)
    v = v_o + v_i[:, None]
    out = (m_o - m_i[:, None]) / torch.sqrt(v.clamp_min(1e-12))
    own = torch.bucketize(torch.arange(r, device=dev),
                          torch.as_tensor(st, device=dev), right=True) - 1
    skip = ((torch.arange(len(b), device=dev)[None] == own[:, None])
            | (inter_ok.sum(dim=2) == 0) | (intra_ok.sum(dim=1) == 0)[:, None])
    return torch.where(skip, _NAN, out)


def call_loop_outs(distmap, starts: Sequence[int], loop_out_th: float = 0.0,
                   window: int = 5, device=None) -> List[Tuple[int, int]]:
    """(region, domain) pairs where the region loops into a foreign domain
    (separation below `loop_out_th`), in row-major order."""
    scores = loop_out_scores(distmap, starts, window, device=device)
    hit = torch.nan_to_num(scores, nan=float("inf")) < loop_out_th
    return [tuple(p) for p in host_array(torch.nonzero(hit)).tolist()]


def genome_distance_summary(chr_2_zxys: Dict[str, np.ndarray], device=None
                            ) -> Tuple[Dict[str, torch.Tensor],
                                       Dict[Tuple[str, str], float]]:
    """Per-chromosome median distance maps (float64 tensors) and median
    inter-chromosome centroid distances across cells.  chr_2_zxys: chr ->
    (n_cells, R_chr, 3) nm traces (NaN = missing)."""
    intra: Dict[str, torch.Tensor] = {}
    cents = {}
    for name, z in chr_2_zxys.items():
        z = as_tensor(z, device).to(f64)
        intra[name] = nanquantile(_distance_map(z), 0.5, dim=0)
        ok = ~torch.isnan(z)
        cents[name] = (torch.where(ok, z, 0.0).sum(dim=1)
                       / ok.sum(dim=1).to(f64))
    inter: Dict[Tuple[str, str], float] = {}
    names = sorted(chr_2_zxys)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            inter[(a, b)] = float(nanquantile(norm(cents[a] - cents[b]),
                                              0.5))
    return intra, inter


# ---------------------------------------------------------------------------
# Iterative inter-domain refinement
# ---------------------------------------------------------------------------


def _blocks(dm: torch.Tensor, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """(D, D, L*L) values of block (j, i) = dm[s_j:e_j, s_i:e_i] and their
    finite mask (padding masked out)."""
    dev = dm.device
    lens = torch.as_tensor([e - s for s, e in b], device=dev)
    width = int(lens.max())
    ar = torch.arange(width, device=dev)
    idx = (torch.as_tensor([s for s, _ in b], device=dev)[:, None]
           + ar[None]).clamp(max=dm.shape[0] - 1)
    ok = ar[None] < lens[:, None]                                   # (D, L)
    vals = dm[idx[:, None, :, None], idx[None, :, None, :]]         # j,i,L,L
    mask = ok[:, None, :, None] & ok[None, :, None, :] & torch.isfinite(vals)
    return vals.flatten(2), mask.flatten(2)


def _stats(vals: torch.Tensor, mask: torch.Tensor, dims):
    """NumPy-style mean and std (ddof 0) over the masked entries; NaN
    where nothing is selected."""
    cnt = mask.sum(dim=dims).to(f64)
    mu = torch.where(mask, vals, 0.0).sum(dim=dims) / cnt
    mu_b = mu.reshape(mu.shape + (1,) * len(dims))
    d = torch.where(mask, vals - mu_b, 0.0)
    return mu, torch.sqrt((d * d).sum(dim=dims) / cnt)


def _logpdf_sum(vals, mask, mu, sd) -> torch.Tensor:
    """Sum over the masked entries of the normal log-density, with the
    JAX package's sigma floor of 1e-9."""
    sd = sd.clamp_min(1e-9)
    t = (vals - mu[..., None]) / sd[..., None]
    terms = -0.5 * (t * t) - torch.log(sd * math.sqrt(2 * math.pi))[..., None]
    return torch.where(mask, terms, 0.0).sum(dim=-1)


def interdomain_likelihood(distmap, starts: Sequence[int],
                           pairs: Sequence[Tuple[int, int]],
                           w_sel: float = 1.0, w_intra: float = 0.05,
                           valid_count: int = 5, normalize: bool = True,
                           exclude_neighbors: bool = True,
                           device=None) -> torch.Tensor:
    """(D, D) log-likelihood-ratio matrix for domain interactions: per
    domain, Gaussians of its called-partner cross blocks (positive), its
    other cross blocks (negative) and its own block; each candidate
    partner's block scores log P(pos) - log P(neg) (weight `w_sel`) plus
    log P(intra) - log P(neg) (weight `w_intra`), per entry when
    `normalize`; self, unscored domains and (optionally) chain neighbours
    are -inf."""
    dm = _map(distmap, device)
    dev = dm.device
    b = _bounds(_sorted_starts(starts), dm.shape[0])
    d = len(b)
    called = torch.zeros((d, d), dtype=torch.bool, device=dev)
    for a, c in pairs:
        called[a, c] = called[c, a] = True
    vals, mask = _blocks(dm, b)                  # [j, i]: block (j, i)
    vals_i, mask_i = vals.transpose(0, 1), mask.transpose(0, 1)   # [i, j]
    eye = torch.eye(d, dtype=torch.bool, device=dev)
    pos_m = mask_i & called[:, :, None]
    neg_m = mask_i & (~called & ~eye)[:, :, None]
    p_mu, p_sd = _stats(vals_i, pos_m, (1, 2))
    n_mu, n_sd = _stats(vals_i, neg_m, (1, 2))
    own = mask_i[eye]                                                # (D, L²)
    i_mu, i_sd = _stats(vals_i[eye], own, (1,))
    n_partners = called.sum(dim=1)
    scored = ((n_partners > 0) & (n_partners < d - 1)
              & (own.sum(dim=1) > valid_count))
    args = (vals_i, mask_i)
    neg = _logpdf_sum(*args, n_mu[:, None], n_sd[:, None])
    pn = _logpdf_sum(*args, p_mu[:, None], p_sd[:, None]) - neg
    inr = _logpdf_sum(*args, i_mu[:, None], i_sd[:, None]) - neg
    if normalize:
        cnt = mask_i.sum(dim=2).to(f64)
        pn, inr = pn / cnt, inr / cnt
    ar = torch.arange(d, device=dev)
    blocked = eye | (mask_i.sum(dim=2) == 0) | ~scored[:, None]
    if exclude_neighbors:
        blocked |= (ar[:, None] - ar[None, :]).abs() == 1
    pn = torch.where(blocked, -float("inf"), pn)
    inr = torch.where(blocked, -float("inf"), inr)
    # the JAX loop adds, for i = 0..D-1, row_pn * w_sel to row i and to
    # column i, then row_in * w_intra likewise: entry (a, b) sums the
    # smaller index's two terms before the larger's (the diagonal is -inf
    # or 0 in any order)
    lo = torch.minimum(ar[:, None], ar[None, :])
    hi = torch.maximum(ar[:, None], ar[None, :])
    lks = torch.zeros((d, d), dtype=f64, device=dev)
    for first, other in ((lo, hi), (hi, lo)):
        if w_sel:
            lks = lks + pn[first, other] * w_sel
        if w_intra:
            lks = lks + inr[first, other] * w_intra
    return lks


def _percentile(values: torch.Tensor, percent: float) -> float:
    """``np.percentile(values, percent)`` (linear), on a 1-D tensor."""
    s = torch.sort(values).values
    n = s.numel()
    virtual = (n - 1) * (percent / 100.0)
    prev = min(max(int(math.floor(virtual)), 0), n - 1)
    nxt = min(prev + 1, n - 1)
    gamma = virtual - prev
    a, b = s[prev], s[nxt]
    diff = b - a
    out = b - diff * (1 - gamma) if gamma >= 0.5 else a + diff * gamma
    return float(out)


def _adjust_pairs_by_likelihood(pairs, lks: torch.Tensor,
                                percent_th: float = 1.0,
                                learning_rate: float = 0.3):
    """Exchange pairs across the likelihood thresholds -> (pairs, removed,
    added)."""
    d = lks.shape[0]
    sel = torch.zeros((d, d), dtype=torch.bool, device=lks.device)
    for a, b in pairs:
        sel[a, b] = sel[b, a] = True
    fin = torch.isfinite(lks)
    sel_lks = lks[sel & fin]
    exc_lks = lks[~sel & fin]
    if sel_lks.numel() == 0 or exc_lks.numel() == 0:
        return list(pairs), 0, 0
    low0 = _percentile(sel_lks, percent_th)
    high0 = _percentile(exc_lks, 100 - percent_th)
    low = low0 + learning_rate * (high0 - low0)
    high = high0 - learning_rate * (high0 - low0)
    if low0 >= high0:
        return list(pairs), 0, 0
    lk = host_array(lks)
    sel = host_array(sel)
    cur = {frozenset(p) for p in pairs}
    removed = added = 0
    for a in range(d):
        for b in range(a + 1, d):
            key = frozenset((a, b))
            if key in cur and sel[a, b] and lk[a, b] < low:
                cur.discard(key)
                removed += 1
            elif key not in cur and np.isfinite(lk[a, b]) \
                    and lk[a, b] > high:
                cur.add(key)
                added += 1
    out = sorted((min(p), max(p)) for p in cur)
    return out, removed, added


def iterative_interdomain_calling(distmap, starts: Sequence[int],
                                  exclude_neighbors: bool = True,
                                  init_th: float = 0.55,
                                  w_sel: float = 1.0,
                                  w_intra: float = 0.05,
                                  max_num_iter: int = 10,
                                  learning_rate: float = 0.3,
                                  adjust_percent_th: float = 1.0,
                                  mean_contact_ratio: float = 0.1,
                                  contact_th: float = 700.0,
                                  device=None) -> List[Tuple[int, int]]:
    """Iteratively refined inter-domain pairs: the separation screen,
    then per iteration the likelihood matrix, pairs exchanged across the
    percentile thresholds, pairs whose mean contact fraction is at most
    `mean_contact_ratio` dropped, until no exchange happens."""
    dm = _map(distmap, device)
    starts = _sorted_starts(starts)
    pairs = inter_domain_interactions(dm, starts, separation_th=init_th,
                                      exclude_neighbors=exclude_neighbors)
    cfreq = None
    for _ in range(int(max_num_iter)):
        if not pairs:
            break
        lks = interdomain_likelihood(dm, starts, pairs, w_sel=w_sel,
                                     w_intra=w_intra,
                                     exclude_neighbors=exclude_neighbors)
        pairs, removed, added = _adjust_pairs_by_likelihood(
            pairs, lks, percent_th=adjust_percent_th,
            learning_rate=learning_rate)
        if cfreq is None:
            cfreq = host_array(domain_contact_freq(dm, starts, contact_th))
        pairs = [p for p in pairs if cfreq[p[0], p[1]] > mean_contact_ratio]
        if removed == 0 and added == 0:
            break
    return [tuple(p) for p in pairs]
