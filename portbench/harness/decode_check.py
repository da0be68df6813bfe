"""The numbers that decide ``correct`` for a field of view's decode: the
program's decoded groups and homolog traces against the plain reference's
decode (``reference/decode.py``) of the same candidate spots.

A decode is held on the host as ``reference.decode.Decoded``: its groups
as (region, sorted spot ids), compared as sets (near-equal neighbours
come back in an order that no two implementations need share), and each
chromosome's ``Traces``: the regions its groups name, the (H, R, 3) trace
in nm and its (H, R) mask.  Homolog labels are the decoder's own, so the
two sides' homologs are matched per chromosome: the order of the
program's homologs that brings the traces closest over the regions both
sides assign.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..reference.decode import Decoded, Traces


def fov_candidates(rounds: Sequence[dict], bit_of) -> Tuple[np.ndarray,
                                                            np.ndarray]:
    """A field of view's rounds on the host (each ``{"spots": (F, N, 11),
    "valid": (F, N)}``, in round order) -> the candidate table the decode
    takes, valid rows of every fitted channel in round then channel order,
    and each row's 1-based codebook bit, ``bit_of(round, f)``."""
    spots, bits = [], []
    for r, out in enumerate(rounds):
        for f in range(len(out["valid"])):
            ok = np.asarray(out["valid"][f], bool)
            spots.append(np.asarray(out["spots"][f], np.float32)[ok])
            bits.append(np.full(int(ok.sum()), bit_of(r, f), np.int64))
    return np.concatenate(spots), np.concatenate(bits)


def program_decoded(decoder, result, region_chr: Dict[int, str]
                    ) -> Optional[Decoded]:
    """The program's decode on the host: its ``DNAMerfishDecoder`` after
    ``decode`` returned `result` (None: the keep-ratio gate refused)."""
    if result is None:
        return None
    g = decoder.spot_groups
    ok = g.ok.cpu().numpy()
    idx = g.spot_idx.cpu().numpy()[ok]
    regions = g.region.cpu().numpy()[ok].astype(np.int64)
    groups = [(int(r), tuple(sorted(int(s) for s in row if s >= 0)))
              for r, row in zip(regions, idx)]
    traces = {}
    for name, res in result.items():
        mine = np.unique([r for r in regions if region_chr[int(r)] == name])
        traces[name] = Traces(mine, res.zxys.cpu().numpy(),
                              res.zxys_valid.cpu().numpy())
    return Decoded(groups, traces)


def _aligned(t: Traces, regions: np.ndarray):
    """`t`'s trace and mask on the region list `regions` (a superset)."""
    h = t.zxys.shape[0]
    z = np.full((h, len(regions), 3), np.nan)
    m = np.zeros((h, len(regions)), bool)
    at = np.searchsorted(regions, t.regions)
    z[:, at] = t.zxys
    m[:, at] = t.assigned
    return z, m


def compare(prog: Optional[Decoded], ref: Optional[Decoded],
            n_cells: int) -> Dict[str, float]:
    """``group_mismatch_share``: groups on one side only over the groups
    of either; ``trace_gap_nm``: the widest distance between the two
    sides' points of a (region, homolog) both assign, homologs matched;
    ``assigned_gap``: the (region, homolog) cells assigned on one side
    only over `n_cells` (the codebook's regions times the homologs).  A
    decode refused on one side only reads infinite."""
    if prog is None or ref is None:
        same = prog is None and ref is None
        v = 0.0 if same else float("inf")
        return {"group_mismatch_share": v, "trace_gap_nm": v,
                "assigned_gap": v}
    a, b = set(prog.groups), set(ref.groups)
    mismatch = len(a ^ b) / max(len(a | b), 1)
    gap, differ = 0.0, 0
    for name in sorted(set(prog.traces) | set(ref.traces)):
        p, r = prog.traces.get(name), ref.traces.get(name)
        if p is None or r is None:
            differ += int((r if p is None else p).assigned.sum())
            continue
        regions = np.union1d(p.regions, r.regions)
        pz, pm = _aligned(p, regions)
        rz, rm = _aligned(r, regions)
        best = None
        for perm in itertools.permutations(range(pz.shape[0])):
            perm = list(perm)
            both = pm[perm] & rm
            d = np.linalg.norm(pz[perm] - rz, axis=-1)[both]
            key = (float(d.sum()), int((pm[perm] != rm).sum()))
            if best is None or key < best[0]:
                best = (key, float(d.max()) if d.size else 0.0)
        gap = max(gap, best[1])
        differ += best[0][1]
    return {"group_mismatch_share": mismatch, "trace_gap_nm": gap,
            "assigned_gap": differ / max(n_cells, 1)}


def decode_rounds(rounds: List[dict], bit_of, codebook, cfg: dict,
                  device) -> Optional[Decoded]:
    """The plain reference's decode of a field of view's rounds."""
    from ..reference.decode import decode_fov

    spots, bits = fov_candidates(rounds, bit_of)
    d = cfg["decode"]
    return decode_fov(spots, bits, codebook, cfg["pipeline"]["pixel_size_nm"],
                      search_th=d["pair_search_radius_nm"],
                      num_homologs=d["num_homologs"],
                      keep_ratio_th=d["keep_ratio_th"], device=device)
