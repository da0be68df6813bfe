"""The numbers that decide ``correct``: the program's outputs against the
plain reference's.

Spot tables: in each fitted channel the valid rows of the two tables are
paired as mutual nearest neighbours within `radius` px (the same seed
gives the same spot on both sides; a seed found on one side only leaves
its spot unpaired).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _nearest(a: np.ndarray, b: np.ndarray, chunk: int = 256):
    """For each row of `a` (n, 3) the index of the nearest row of `b`
    (m, 3) and its squared distance, in float64."""
    idx = np.zeros(len(a), np.int64)
    d2 = np.full(len(a), np.inf)
    if len(b) == 0:
        return idx, d2
    for s in range(0, len(a), chunk):
        d = ((a[s:s + chunk, None, :] - b[None]) ** 2).sum(-1)
        idx[s:s + chunk] = d.argmin(1)
        d2[s:s + chunk] = d[np.arange(len(d)), idx[s:s + chunk]]
    return idx, d2


#: a pair of spots counts as moved beyond this gap in any coordinate (px,
#: ~8 float32 ulps at 2048) or this relative gap in height
MOVED_PX = 1e-3
MOVED_HEIGHT = 1e-3


def spot_tables(prog_spots, prog_valid, ref_spots, ref_valid,
                radius: float = 0.5) -> Dict[str, float]:
    """(F, N, 11) tables and (F, N) masks of one round -> the spots on
    either side without a partner within `radius` (``unpaired``), those
    and the pairs that moved beyond MOVED_PX or MOVED_HEIGHT (``moved``),
    the valid reference spots, the widest coordinate gap of a pair (px,
    any axis) and the widest relative height gap of a pair."""
    out = {"unpaired": 0, "moved": 0, "n_ref": 0, "spot_gap_px": 0.0,
           "height_gap": 0.0}
    for f in range(len(ref_spots)):
        a = np.asarray(prog_spots[f], np.float64)[np.asarray(prog_valid[f],
                                                             bool)]
        b = np.asarray(ref_spots[f], np.float64)[np.asarray(ref_valid[f],
                                                            bool)]
        ia, da = _nearest(a[:, 1:4], b[:, 1:4])
        ib, _ = _nearest(b[:, 1:4], a[:, 1:4])
        mutual = (da <= radius ** 2) & (ib[ia] == np.arange(len(a))) \
            if len(b) else np.zeros(len(a), bool)
        pa, pb = a[mutual], b[ia[mutual]]
        n_pair = int(mutual.sum())
        unpaired = (len(a) - n_pair) + (len(b) - n_pair)
        out["unpaired"] += unpaired
        out["moved"] += unpaired
        out["n_ref"] += len(b)
        if n_pair:
            gap = np.abs(pa[:, 1:4] - pb[:, 1:4]).max(axis=1)
            hgap = (np.abs(pa[:, 0] - pb[:, 0])
                    / np.maximum(np.abs(pb[:, 0]), 1e-6))
            out["moved"] += int(((gap > MOVED_PX)
                                 | (hgap > MOVED_HEIGHT)).sum())
            out["spot_gap_px"] = max(out["spot_gap_px"], float(gap.max()))
            out["height_gap"] = max(out["height_gap"], float(hgap.max()))
    return out
