"""The spot gap held only where the summation order does not decide a fit.

The program's and the reference's valid spots of each fitted channel are
paired as ``compare.spot_tables`` pairs them (mutual nearest neighbours
within `radius` px); a pair counts when the reference names its spot as
not decided by the order of its pixels (``reference/pixel_order.py``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .compare import _nearest


def held_gap(prog_spots, prog_valid, ref_spots, ref_valid, decided,
             radius: float = 0.5) -> Dict[str, float]:
    """(F, N, 11) tables, (F, N) masks of one round and the reference's
    (F, N) order-decided spots -> the widest coordinate gap (px, any axis)
    of a pair whose reference spot the order does not decide
    (``spot_gap_px``), and the valid reference spots the order decides
    (``decided``) out of ``n_ref``."""
    out = {"spot_gap_px": 0.0, "decided": 0, "n_ref": 0}
    for f in range(len(ref_spots)):
        va = np.asarray(prog_valid[f], bool)
        vb = np.asarray(ref_valid[f], bool)
        a = np.asarray(prog_spots[f], np.float64)[va]
        b = np.asarray(ref_spots[f], np.float64)[vb]
        held_b = ~np.asarray(decided[f], bool)[vb]
        out["decided"] += int((~held_b).sum())
        out["n_ref"] += len(b)
        if not len(a) or not len(b):
            continue
        ia, da = _nearest(a[:, 1:4], b[:, 1:4])
        ib, _ = _nearest(b[:, 1:4], a[:, 1:4])
        mutual = (da <= radius ** 2) & (ib[ia] == np.arange(len(a)))
        pair = mutual & held_b[ia]
        if pair.any():
            gap = np.abs(a[pair, 1:4] - b[ia[pair], 1:4]).max(axis=1)
            out["spot_gap_px"] = max(out["spot_gap_px"], float(gap.max()))
    return out
