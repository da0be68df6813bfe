"""Picked-spot sanity checks and candidate filtering.

The counterpart of ``imageanalysis3_tpu/decode/checking.py``.  Behavior
targets (reference spot_tools/checking.py): check_spot_scores (:9-169),
filter_candidate_spots (:170-191).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT_PIXEL_SIZE_NM
from ..device import as_tensor, resolve_device
from ..ops.filters import nanquantile
from .scoring import (_trace_center, chromosome_ref_stats, norm, pixel_sizes,
                      score_candidates)


def check_picked_spots(trace, sel_valid, chrom_center=None,
                       pixel_size_nm=DEFAULT_PIXEL_SIZE_NM,
                       check_th: float = -3.5,
                       check_percentile: float = 1.0,
                       hard_dist_th: float = 6000.0,
                       local_size: int = 5,
                       w_ctdist: float = 2.0, w_lcdist: float = 1.0,
                       w_int: float = 1.0, device=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stringency screen on a picked trace -> (kept mask, scores).

    A pick survives iff its score >= max(check_th * (w_ct + w_lc + w_int),
    `check_percentile`-th percentile of picked scores) and it lies within
    `hard_dist_th` nm of the chromosome center (reference
    check_spot_scores, spot_tools/checking.py:9-169).  The percentile is
    ``jnp.nanpercentile``'s (linear, q / 100 in float32).
    """
    dev = resolve_device(device)
    trace = as_tensor(trace, dev).to(torch.float32)
    sel_valid = as_tensor(sel_valid, dev).to(torch.bool)
    center = (None if chrom_center is None
              else as_tensor(chrom_center, dev).to(torch.float32))
    px = pixel_sizes(pixel_size_nm, trace.device)
    safe = torch.where(sel_valid[:, None], trace, 0.0)
    refs = chromosome_ref_stats(safe, sel_valid, center, pixel_size_nm,
                                local_size)
    scores = score_candidates(safe[:, None], sel_valid[:, None], safe,
                              sel_valid, center, refs, pixel_size_nm,
                              local_size, w_ctdist, w_lcdist, w_int)[:, 0]
    th_abs = torch.tensor(check_th * (w_ctdist + w_lcdist + w_int),
                          dtype=torch.float32, device=trace.device)
    finite = torch.where(sel_valid & torch.isfinite(scores), scores,
                         float("nan"))
    q = float(np.float32(check_percentile) / np.float32(100.0))
    th_pct = nanquantile(finite, q)
    th = torch.maximum(th_abs, torch.where(torch.isnan(th_pct),
                                           float("-inf"), th_pct))
    zxys = safe[:, 1:4] * px
    ct = norm(zxys - _trace_center(zxys, sel_valid, center, px)[None])
    keep = sel_valid & (scores >= th) & (ct <= hard_dist_th)
    return keep, torch.where(sel_valid, scores, float("nan"))


def filter_candidate_spots(spots: np.ndarray,
                           valid: Optional[np.ndarray] = None,
                           background_th=(100.0, np.inf),
                           height_th=(800.0, np.inf),
                           sigma_xy_th=(0.5, 3.0),
                           sigma_z_th=(0.5, 3.5)) -> np.ndarray:
    """Empirical bounds screen on (N, 11) rows -> keep mask (reference
    filter_candidate_spots, spot_tools/checking.py:170-191)."""
    spots = np.atleast_2d(np.asarray(spots))
    keep = ((spots[:, 4] >= min(background_th))
            & (spots[:, 4] <= max(background_th))
            & (spots[:, 0] >= min(height_th))
            & (spots[:, 0] <= max(height_th))
            & (spots[:, 6] >= min(sigma_xy_th))
            & (spots[:, 6] <= max(sigma_xy_th))
            & (spots[:, 7] >= min(sigma_xy_th))
            & (spots[:, 7] <= max(sigma_xy_th))
            & (spots[:, 5] >= min(sigma_z_th))
            & (spots[:, 5] <= max(sigma_z_th)))
    if valid is not None:
        keep = keep & np.asarray(valid, bool)
    return keep
