"""New-generation table picker: score-based iterative homolog assignment
over decoded spot-group tables.

The counterpart of ``imageanalysis3_tpu/decode/picker.py``.  Behavior
target: reference classes/picker.py (SpotPicker :15-538, batch_pick_spots
:539-632, prepare_score_metrics_by_chr :560-600, cdf_scores :601-612):

  1. merge per-library codebooks + decoded coordinates, ordering regions
     along each chromosome by genomic midpoint (`chr_order`);
  2. initialize per-chromosome homolog centres (weighted k-means, one
     cluster per expected chromosome copy);
  3. score every candidate against every homolog with three weighted
     log-CDF metrics -- intensity (greater is better), distance to the
     homolog centre, and distance to the local neighbourhood of the
     previous picked trace (both smaller is better), the CDF pooled over
     ALL chromosomes;
  4. per region, pick the best per-homolog assignment by exhaustive
     permutation of candidates;
  5. shrink homolog centres toward the picked means, re-score and
     re-assign until the changed fraction per chromosome drops below
     `change_th`, skipping chromosomes that have settled;
  6. filter picked spots whose score falls below
     sum(weights) * log(0.05).

Split.  The table plumbing stays on the host in NumPy: merging codebooks
and coordinate tables (column mappings, as ``io.spots``), parsing
``chr:start-end`` names, ``chr_order`` (``np.argsort`` called as the JAX
package calls it, so tied midpoints order alike).  The numeric core runs
as float64 tensors on the picker's device (the CUDA card unless
``device="cpu"``): pooled-CDF scores by sorted pools and ``searchsorted``,
the metric tensor with its local-window ``nanmean``s as masked sums,
weighted k-means, and the per-region exhaustive assignment, where every
region with the same candidate count is scored at once against one table
of the assignments in ``itertools`` order, and the first maximum wins, so
ties break as in the JAX package.  The picker's per-chromosome results
(``chr_2_*``) are tensors on that device.  Files: h5py where it imports,
the ``.npy`` layout of ``io.spots`` where it does not.
"""

from __future__ import annotations

import math
from functools import lru_cache
from itertools import permutations, product
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import as_tensor, resolve_device
from ..io.spots import (Table, column, is_group, n_rows, open_table_file,
                        read_table, to_dataframe, write_table)

#: reference picker.py:10-12
AXIS3D_INFOS = ("z", "x", "y")
DEFAULT_WEIGHTS = (5.0, 2.0, 1.0)
DEFAULT_SCORE_TH = math.log(0.05)
DEFAULT_COORDS_COLUMNS = [
    "region_name", "chr", "start", "end", "center_z", "center_x",
    "center_y", "center_intensity", "center_internal_dist"]

_F64 = torch.float64


def _f64(x, device) -> torch.Tensor:
    return as_tensor(x, device).to(device=device, dtype=_F64)


def _norm3(d: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last dim, squares summed left to right."""
    s = d[..., 0] * d[..., 0]
    for k in range(1, d.shape[-1]):
        s = s + d[..., k] * d[..., k]
    return torch.sqrt(s)


def _masked_mean(mask: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """nanmean of `values` (m, 3) over the rows each mask row (n, m)
    selects, per column; NaN where a row selects no finite value."""
    ok = ~torch.isnan(values)
    tot = mask.to(_F64) @ torch.where(ok, values, 0.0)
    cnt = mask.to(_F64) @ ok.to(_F64)
    return tot / cnt


# ---------------------------------------------------------------------------
# Scoring primitives (reference picker.py:560-612)
# ---------------------------------------------------------------------------


def cdf_scores(values, refs, greater: bool = True,
               device=None) -> torch.Tensor:
    """Weak-percentile CDF mapped into the open interval (0, 1).

    Reference cdf_scores (classes/picker.py:601-612):
    `percentileofscore(refs, v, kind='weak') / 100 * n/(n+2) + 1/(n+2)`
    (complemented when `greater=False`).  NaN refs stay in the pool: they
    never compare <= v but count in the denominator; NaN values count 0.
    One sort of the finite refs + ``searchsorted``."""
    dev = (values.device if isinstance(values, torch.Tensor)
           else resolve_device(device))
    refs = _f64(refs, dev).reshape(-1)
    values = _f64(values, dev)
    bad = torch.isnan(refs)
    if refs.numel() == 0 or bool(bad.all()):
        return torch.full(values.shape, float("nan"), dtype=_F64,
                          device=dev)
    n = refs.numel()
    finite = torch.sort(refs[~bad]).values
    isnan = torch.isnan(values)
    counts = torch.searchsorted(
        finite, torch.where(isnan, 0.0, values).contiguous(),
        right=True).to(_F64)
    counts = torch.where(isnan, 0.0, counts)
    p = counts / n
    if greater:
        return p * n / (n + 2) + 1.0 / (n + 2)
    return 1.0 - p * n / (n + 2) - 1.0 / (n + 2)


def prepare_score_metrics_by_chr(hzxys, region_ids, homolog_center_zxys,
                                 prev_homolog_hzxys=None,
                                 local_range: int = 5,
                                 device=None) -> torch.Tensor:
    """(3, n_homologs, n_cands) float64 metric tensor for one chromosome.

    Reference prepare_score_metrics_by_chr (classes/picker.py:560-600):
      metric 0: candidate intensity (same for every homolog);
      metric 1: euclidean distance to each homolog centre;
      metric 2: distance to the local neighbourhood -- first round: the
        nanmean of OTHER candidates whose region id is within
        +-local_range; later rounds: per homolog, the nanmean of the
        previous picked trace over region indices
        [id-local_range, id+local_range] without the candidate's own row
        index (the reference's mixed-index quirk, kept for parity)."""
    dev = (hzxys.device if isinstance(hzxys, torch.Tensor)
           else resolve_device(device))
    hzxys = _f64(hzxys, dev)
    rid = as_tensor(region_ids, dev).to(device=dev, dtype=torch.int64)
    centers = torch.atleast_2d(_f64(homolog_center_zxys, dev))
    n_homologs, n = centers.shape[0], hzxys.shape[0]
    if n == 0:
        return torch.zeros((3, n_homologs, 0), dtype=_F64, device=dev)
    metrics = torch.full((3, n_homologs, n), float("nan"), dtype=_F64,
                         device=dev)
    metrics[0] = hzxys[:, 0][None]
    metrics[1] = _norm3(centers[:, None, :] - hzxys[None, :, 1:])
    rows = torch.arange(n, device=dev)
    if prev_homolog_hzxys is None:
        win = ((rid[None, :] - rid[:, None]).abs() <= local_range) & \
            (rows[None, :] != rows[:, None])
        ctr = _masked_mean(win, hzxys[:, 1:])
        d = _norm3(hzxys[:, 1:] - ctr)
        metrics[2] = torch.where(win.any(dim=1), d, float("nan"))[None]
    else:
        prev = _f64(prev_homolog_hzxys, dev)
        if prev.shape[0] != n_homologs:
            raise IndexError("length of prev_homolog_hzxys doesn't match")
        reg = torch.arange(prev.shape[1], device=dev)
        win = ((reg[None, :] - rid[:, None]).abs() <= local_range) & \
            (reg[None, :] != rows[:, None])
        has = win.any(dim=1)
        for h in range(n_homologs):
            ctr = _masked_mean(win, prev[h][:, 1:])
            d = _norm3(hzxys[:, 1:] - ctr)
            metrics[2, h] = torch.where(has, d, float("nan"))
    return metrics


def weighted_kmeans(points, weights, k: int, n_iters: int = 50,
                    device=None) -> torch.Tensor:
    """Deterministic weighted Lloyd k-means, float64 (reference uses
    sklearn KMeans(random_state=0) with sample weights, picker.py:186-194;
    this farthest-point-seeded variant is deterministic without sklearn):
    the first centre is the heaviest point, each next one the point of
    the largest weighted squared distance to the centres so far (first
    maximum), then `n_iters` weighted Lloyd steps."""
    dev = (points.device if isinstance(points, torch.Tensor)
           else resolve_device(device))
    pts = _f64(points, dev)
    w = _f64(weights, dev)
    ok = ~torch.isnan(pts).any(dim=1)
    pts, w = pts[ok], w[ok]
    if pts.shape[0] < k:
        raise ValueError(f"need >= {k} points for k-means")

    def sq(c):
        d = pts - c
        return d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]

    centers = [pts[torch.argmax(w)]]
    d2 = sq(centers[0])
    for _ in range(k - 1):
        centers.append(pts[torch.argmax(d2 * w)])
        d2 = torch.minimum(d2, sq(centers[-1]))
    centers = torch.stack(centers)
    for _ in range(n_iters):
        d = pts[:, None] - centers[None]
        lab = torch.argmin((d * d).sum(dim=-1), dim=1)
        onehot = (lab[:, None] == torch.arange(k, device=dev)[None]).to(_F64)
        wsum = onehot.T @ w
        mean = (onehot * w[:, None]).T @ pts / wsum[:, None]
        centers = torch.where((wsum > 0)[:, None], mean, centers)
    return centers


@lru_cache(maxsize=64)
def _assignment_table(n: int, k: int, overlap: bool) -> Tuple[Tuple[int]]:
    """The assignments in itertools' order: ``permutations(range(n), k)``,
    or ``product(range(n), repeat=k)`` with overlap."""
    it = (product(range(n), repeat=k) if overlap
          else permutations(range(n), k))
    return tuple(it)


def _assignments(n: int, k: int, overlap: bool, device) -> torch.Tensor:
    """(A, k) int64 table of :func:`_assignment_table` on `device`."""
    return torch.tensor(_assignment_table(n, k, overlap),
                        dtype=torch.int64, device=device).reshape(-1, k)


def _nanmean_rows(vals: List[torch.Tensor]) -> torch.Tensor:
    """NumPy's nanmean across a short list of equal-shape tensors, the
    values summed in list order."""
    tot, cnt = None, None
    for v in vals:
        ok = ~torch.isnan(v)
        x = torch.where(ok, v, 0.0)
        tot = x if tot is None else tot + x
        cnt = ok.to(_F64) if cnt is None else cnt + ok.to(_F64)
    return tot / cnt


def _first_argmax(means: torch.Tensor) -> torch.Tensor:
    """np.argmax along the last dim: the first NaN if any, else the first
    maximum."""
    return torch.argmax(torch.where(torch.isnan(means), float("inf"),
                                    means), dim=-1)


# ---------------------------------------------------------------------------
# Host table helpers
# ---------------------------------------------------------------------------


def _is_numeric(arr: np.ndarray) -> bool:
    return arr.dtype.kind in "biuf"


def _concat_tables(tables: Sequence[Mapping], fill_zero: bool) -> Table:
    """Row-wise concatenation over the union of columns (first-appearance
    order), as ``pd.concat(join="outer", ignore_index=True)``: a column a
    table lacks is NaN (None for text) there; with `fill_zero` every NaN
    or None becomes 0, as ``.fillna(0)``."""
    names: List = []
    for t in tables:
        names += [c for c in t.keys() if c not in names]
    out: Table = {}
    for c in names:
        parts = [column(t, c) if c in list(t.keys()) else None
                 for t in tables]
        present = [p for p in parts if p is not None]
        numeric = all(_is_numeric(p) for p in present)
        missing = any(p is None for p in parts)
        if numeric:
            dtype = np.float64 if missing else None
            arr = np.concatenate([
                np.full(n_rows(t), np.nan) if p is None else p
                for t, p in zip(tables, parts)]).astype(
                dtype if dtype else np.result_type(*present))
            if fill_zero and arr.dtype.kind == "f":
                arr = np.where(np.isnan(arr), 0.0, arr)
        else:
            if missing:
                arr = np.concatenate([
                    np.full(n_rows(t), None, object) if p is None
                    else p.astype(object) for t, p in zip(tables, parts)])
            else:
                arr = np.concatenate(present)
            if fill_zero and arr.dtype == object:
                arr = np.asarray([0 if (v is None or (
                    isinstance(v, float) and np.isnan(v))) else v
                    for v in arr], object)
        out[c] = arr
    return out


def _text(arr) -> np.ndarray:
    return np.asarray(arr).astype(str)


# ---------------------------------------------------------------------------
# The picker
# ---------------------------------------------------------------------------


class SpotPicker:
    """Score-based iterative homolog picking over decoded tables
    (reference SpotPicker, classes/picker.py:15-538).

    Parameters
    ----------
    coords : merged candidate table (a column mapping) -- one row per
        decoded group / candidate spot with at least `region_name`, `chr`,
        `center_z/x/y`, `center_intensity`; alternatively pass
        `decoded_file`.
    codebook : merged codebook table with `name` ('chr:start-end') and
        `chr` columns; region order along each chromosome comes from the
        genomic midpoint parsed from `name`.
    decoded_file : file written by the decoders (library groups holding
        `spotGroups`/`candSpots` + `codebook` columnar tables), HDF5 or a
        ``.npy`` directory.
    chr_2_copy_num : chromosome -> expected homolog count; default 2 with
        X/Y overridden by `male` (reference _generate_default_chr_copyNum).
    device : where the numeric core runs (default the CUDA card).
    """

    def __init__(self, coords: Optional[Mapping] = None,
                 codebook: Optional[Mapping] = None,
                 decoded_file: Optional[str] = None,
                 metric_weights: Sequence[float] = DEFAULT_WEIGHTS,
                 valid_score_th: float = DEFAULT_SCORE_TH,
                 chr_2_copy_num: Optional[Dict[str, int]] = None,
                 male: bool = True,
                 save_file: Optional[str] = None,
                 verbose: bool = False, device=None):
        self.device = resolve_device(device)
        self.decoded_file = decoded_file
        self.save_file = save_file
        self.male = male
        self.metric_weights = np.asarray(metric_weights, np.float64)
        self.valid_score_th = float(valid_score_th)
        self.verbose = verbose
        self.chr_2_copy_num = (dict(chr_2_copy_num)
                               if isinstance(chr_2_copy_num, dict) else None)
        self._coords_in = coords
        self._codebook_in = codebook
        # iteration history (reference history_* buffers)
        self.history_homolog_centers: List[Dict] = []
        self.history_homolog_hzxys: List[Dict] = []
        self.history_homolog_inds: List[Dict] = []
        self.chr_2_homolog_centers: Dict[str, torch.Tensor] = {}
        self.chr_2_homolog_hzxys: Dict[str, torch.Tensor] = {}
        self.chr_2_homolog_inds: Dict[str, torch.Tensor] = {}
        self.chr_2_scores: Dict[str, torch.Tensor] = {}
        self.chr_2_change: Dict[str, bool] = {}
        self.chr_2_change_fraction: Dict[str, float] = {}

    # -- loading / merging ------------------------------------------------

    def _load_decoded(self) -> Tuple[List[Table], List[Table]]:
        """Scan the decoded file for per-library groups (reference
        _load_decoded, picker.py:54-100: `spotGroups` => combo libraries,
        `candSpots` => unique libraries, each with a sibling codebook)."""
        codebooks, coords = [], []
        with open_table_file(self.decoded_file, "r") as fh:
            plans = []
            for name in fh.keys():
                if name == "picked" or not is_group(fh[name]):
                    continue
                keys = set(fh[name].keys())
                if "spotGroups" in keys:
                    plans.append((name, "spotGroups", "combo"))
                elif "candSpots" in keys:
                    plans.append((name, "candSpots", "unique"))
            for name, key, dtype in plans:
                cb = read_table(fh, f"{name}/codebook")
                n_cb = n_rows(cb)
                cb["library"] = np.full(n_cb, name)
                cb["dtype"] = np.full(n_cb, dtype)
                codebooks.append(cb)
                df = read_table(fh, f"{name}/{key}")
                n = n_rows(df)
                if n == 0:
                    continue
                sel: Table = {c: (column(df, c) if c in df
                                  else np.full(n, np.nan))
                              for c in DEFAULT_COORDS_COLUMNS}
                sel["codebook_name"] = np.full(n, name)
                sel["data_type"] = np.full(n, dtype)
                h_cols = [c for c in df if "height" in str(c)]
                sel["num_spots"] = (
                    np.sum([~np.isnan(column(df, c).astype(np.float64))
                            for c in h_cols], axis=0).astype(np.int64)
                    if h_cols else np.ones(n, np.int64))
                coords.append(sel)
        return codebooks, coords

    def _merge_decoded(self) -> None:
        """Merge codebooks + coords; order regions along chromosomes by
        genomic midpoint (reference _merge_decoded, picker.py:101-141)."""
        if self._coords_in is not None:
            codebooks = [{c: column(self._codebook_in, c).copy()
                          for c in self._codebook_in.keys()}]
            coords = [{c: column(self._coords_in, c).copy()
                       for c in self._coords_in.keys()}]
        else:
            codebooks, coords = self._load_decoded()
        if not codebooks or not coords:
            self.merged_codebook: Table = {}
            self.merged_coords: Table = {}
            return
        cb = _concat_tables(codebooks, fill_zero=True)
        names = [str(n) for n in cb["name"]]
        spans = [n.split(":")[1].split("-") for n in names]
        reg_mid = np.asarray([(int(s[0]) + int(s[1])) / 2 for s in spans])
        chr_order = np.zeros(len(names), np.int64)
        chrs = cb["chr"]
        for chrom in np.unique(chrs):
            idx = np.nonzero(chrs == chrom)[0]
            order = np.argsort(reg_mid[idx])
            chr_order[idx[order]] = np.arange(len(idx), dtype=np.int32)
        cb["chr_order"] = chr_order
        self.merged_codebook = cb
        name_to_order = dict(zip(names, chr_order))
        name_to_ind = {n: i for i, n in enumerate(names)}
        mc = _concat_tables(coords, fill_zero=False)
        regions = [str(r) for r in mc["region_name"]]
        mc["index"] = np.asarray([name_to_ind[r] for r in regions],
                                 np.int64)
        mc["chr_order"] = np.asarray([int(name_to_order[r])
                                      for r in regions], np.int64)
        self.merged_coords = mc
        if self.verbose:
            print(f"{n_rows(mc)} candidates for {len(names)} regions")

    def _generate_default_copy_num(self) -> None:
        """Autosomes 2; X/Y 1/1 (male) or 2/0 (reference
        _generate_default_chr_copyNum, picker.py:142-155).  As in the JAX
        package, X and Y are always set, whether the codebook holds them
        or not."""
        if self.chr_2_copy_num is not None:
            return
        self.chr_2_copy_num = {str(c): 2
                               for c in np.unique(self.merged_codebook["chr"])}
        self.chr_2_copy_num["X"] = 1 if self.male else 2
        self.chr_2_copy_num["Y"] = 1 if self.male else 0

    # -- per-chromosome candidate views ----------------------------------

    def _chr_candidates(self, chrom: str):
        df = self.merged_coords
        rows = np.nonzero(_text(df["chr"]) == str(chrom))[0]
        hzxys = np.stack([column(df, "center_intensity")]
                         + [column(df, f"center_{a}") for a in AXIS3D_INFOS],
                         axis=1)[rows].astype(np.float64)
        ids = column(df, "chr_order")[rows].astype(np.int64)
        dev = self.device
        return (torch.as_tensor(rows, device=dev),
                torch.as_tensor(hzxys, device=dev),
                torch.as_tensor(ids, device=dev))

    def _init_homolog_centers(self, min_spot_num: int = 2) -> None:
        """Weighted k-means (weight 1/count-per-region) per chromosome
        (reference _init_homolog_centers, picker.py:156-194)."""
        self.chr_2_cand_rows = {}
        self.chr_2_cand_hzxys = {}
        self.chr_2_cand_ids = {}
        for chrom, copy_num in self.chr_2_copy_num.items():
            rows, hzxys, ids = self._chr_candidates(chrom)
            if len(rows) < max(min_spot_num, copy_num) or copy_num == 0:
                continue
            self.chr_2_cand_rows[chrom] = rows
            self.chr_2_cand_hzxys[chrom] = hzxys
            self.chr_2_cand_ids[chrom] = ids
            _, inv, cnt = torch.unique(ids, return_inverse=True,
                                       return_counts=True)
            w = 1.0 / cnt.to(_F64)[inv]
            self.chr_2_homolog_centers[chrom] = weighted_kmeans(
                hzxys[:, 1:], w, int(copy_num))

    # -- scoring ----------------------------------------------------------

    def _prepare_score_metrics(self, local_range: int = 5) -> None:
        self.chr_2_metrics = {}
        for chrom, centers in self.chr_2_homolog_centers.items():
            prev = self.chr_2_homolog_hzxys.get(chrom)
            self.chr_2_metrics[chrom] = prepare_score_metrics_by_chr(
                self.chr_2_cand_hzxys[chrom], self.chr_2_cand_ids[chrom],
                centers, prev_homolog_hzxys=prev, local_range=local_range)

    def _calculate_scores(self) -> None:
        """Pooled-CDF weighted log scores (reference _calculate_scores,
        picker.py:233-270): the CDF reference pool of each metric is the
        concatenation across ALL chromosomes.  Each chromosome's scores
        are also written to the `score_h<h>` columns of `merged_coords`."""
        if not self.chr_2_metrics:
            return
        pools = [torch.cat([m[k].reshape(-1)
                            for m in self.chr_2_metrics.values()])
                 for k in range(3)]
        self.chr_2_scores = {}
        w = self.metric_weights
        n_coords = n_rows(self.merged_coords)
        for chrom, m in self.chr_2_metrics.items():
            total = None
            for k, greater in enumerate((True, False, False)):
                part = torch.log(cdf_scores(m[k], pools[k],
                                            greater=greater)) * w[k]
                part = torch.where(torch.isnan(part), 0.0, part)
                total = part if total is None else total + part
            self.chr_2_scores[chrom] = total
            host = total.cpu().numpy()
            rows = self.chr_2_cand_rows[chrom].cpu().numpy()
            for h in range(len(self.chr_2_homolog_centers[chrom])):
                col = f"score_h{h}"
                if col not in self.merged_coords:
                    self.merged_coords[col] = np.full(n_coords, np.nan)
                self.merged_coords[col][rows] = host[h]

    # -- assignment -------------------------------------------------------

    def _assign_chromosome(self, chrom: str, allow_overlap: bool):
        """Per-region exhaustive best assignment of one chromosome: every
        region with the same candidate count scored at once."""
        dev = self.device
        scores = self.chr_2_scores[chrom]
        rows = self.chr_2_cand_rows[chrom]
        hzxys = self.chr_2_cand_hzxys[chrom]
        ids = self.chr_2_cand_ids[chrom]
        n_h = len(self.chr_2_homolog_centers[chrom])
        n_regions = int((_text(self.merged_codebook["chr"])
                         == str(chrom)).sum())
        picked = torch.full((n_h, n_regions, 4), float("nan"), dtype=_F64,
                            device=dev)
        picked_inds = torch.full((n_h, n_regions), -1, dtype=torch.int64,
                                 device=dev)
        inside = (ids >= 0) & (ids < n_regions)
        order = torch.argsort(torch.where(inside, ids, n_regions),
                              stable=True)
        counts = torch.bincount(ids[inside], minlength=n_regions)
        first = torch.cumsum(counts, 0) - counts
        counts_h = counts.cpu().numpy()
        for c in np.unique(counts_h[counts_h > 0]):
            c = int(c)
            regs = torch.as_tensor(np.nonzero(counts_h == c)[0], device=dev)
            cand = order[first[regs][:, None]
                         + torch.arange(c, device=dev)[None]]   # (R_c, c)
            cs = scores[:, cand]                                 # (H, R_c, c)
            if c >= n_h:
                table = _assignments(c, n_h, allow_overlap, dev)
                best = _first_argmax(_nanmean_rows(
                    [cs[h][:, table[:, h]] for h in range(n_h)]))
                for h in range(n_h):
                    j = cand.gather(1, table[best, h][:, None])[:, 0]
                    picked[h, regs] = hzxys[j]
                    picked_inds[h, regs] = rows[j]
            else:
                table = _assignments(n_h, c, allow_overlap, dev)
                best = _first_argmax(_nanmean_rows(
                    [cs[table[:, j], :, j].T for j in range(c)]))
                for j in range(c):
                    # in candidate order: with overlap a later candidate
                    # overwrites an earlier one given the same homolog
                    h = table[best, j]
                    picked[h, regs] = hzxys[cand[:, j]]
                    picked_inds[h, regs] = rows[cand[:, j]]
        return picked, picked_inds

    def _assign_homologs_by_scores(self, allow_overlap: bool = False
                                   ) -> None:
        """Per-region exhaustive best assignment (reference
        _assign_homologs_by_scores, picker.py:271-343).  The reference's
        allow_overlap=True branch calls `product(arange(n), k)` (a
        TypeError); as in the JAX package, overlap enumerates
        `product(range(n), repeat=k)`."""
        if self.chr_2_homolog_hzxys:
            self.history_homolog_hzxys.append(dict(self.chr_2_homolog_hzxys))
            self.history_homolog_inds.append(dict(self.chr_2_homolog_inds))
        new_hzxys, new_inds = {}, {}
        for chrom in self.chr_2_scores:
            if self.chr_2_change.get(chrom) is False:
                new_hzxys[chrom] = self.history_homolog_hzxys[-1][chrom]
                new_inds[chrom] = self.history_homolog_inds[-1][chrom]
                continue
            new_hzxys[chrom], new_inds[chrom] = self._assign_chromosome(
                chrom, allow_overlap)
        self.chr_2_homolog_hzxys = new_hzxys
        self.chr_2_homolog_inds = new_inds

    def _update_homolog_centers(self, change_shrink: float = 0.8) -> None:
        """centers += shrink * (picked nanmean - centers) (reference
        _update_homolog_centers, picker.py:344-357)."""
        self.history_homolog_centers.append(
            dict(self.chr_2_homolog_centers))
        for chrom, picked in self.chr_2_homolog_hzxys.items():
            old = self.chr_2_homolog_centers[chrom]
            zxy = picked[:, :, 1:]
            ok = ~torch.isnan(zxy)
            mean = (torch.where(ok, zxy, 0.0).sum(dim=1)
                    / ok.to(_F64).sum(dim=1))
            delta = torch.where(torch.isnan(mean), 0.0, mean - old)
            self.chr_2_homolog_centers[chrom] = old + change_shrink * delta

    def _determine_selection_changes(self, change_th: float = 0.01) -> None:
        if not self.chr_2_change_fraction:
            self.chr_2_change_fraction = {
                c: 1.0 for c in self.chr_2_homolog_centers}
            self.chr_2_change = {c: True
                                 for c in self.chr_2_homolog_centers}
        if not self.history_homolog_inds:
            return
        for chrom, inds in self.chr_2_homolog_inds.items():
            frac = float((self.history_homolog_inds[-1][chrom] != inds)
                         .to(_F64).mean())
            self.chr_2_change_fraction[chrom] = frac
            self.chr_2_change[chrom] = frac > change_th

    def _filter_selected_by_scores(self) -> None:
        """Invalidate picks scoring below sum(weights)*log(0.05)
        (reference _filter_selected_by_scores, picker.py:370-400): a pick's
        score is its row's latest `score_h<h>`."""
        th = float(np.sum(self.metric_weights)) * self.valid_score_th
        self.chr_2_filtered_hzxys = {}
        self.chr_2_filtered_inds = {}
        for chrom, picked in self.chr_2_homolog_hzxys.items():
            inds = self.chr_2_homolog_inds[chrom]
            rows = self.chr_2_cand_rows[chrom]
            scores = self.chr_2_scores[chrom]
            ok = inds >= 0
            pos = torch.searchsorted(rows, inds.clamp_min(0).contiguous())
            pos = pos.clamp_max(rows.shape[0] - 1)
            sc = torch.where(ok, scores.gather(1, pos), float("nan"))
            neg = sc < th
            self.chr_2_filtered_hzxys[chrom] = torch.where(
                neg[..., None], float("nan"), picked)
            self.chr_2_filtered_inds[chrom] = torch.where(neg, -1, inds)

    # -- composite steps ---------------------------------------------------

    def first_assignment(self, min_spot_num: int = 2, local_range: int = 5,
                         allow_overlap: bool = False) -> None:
        self._merge_decoded()
        if n_rows(self.merged_coords) == 0:
            return
        self._generate_default_copy_num()
        self._init_homolog_centers(min_spot_num=min_spot_num)
        self._prepare_score_metrics(local_range=local_range)
        self._calculate_scores()
        self._assign_homologs_by_scores(allow_overlap=allow_overlap)

    def update_assignment(self, change_shrink: float = 0.8,
                          local_range: int = 5,
                          allow_overlap: bool = False,
                          change_th: float = 0.01) -> None:
        self._update_homolog_centers(change_shrink=change_shrink)
        self._prepare_score_metrics(local_range=local_range)
        self._calculate_scores()
        self._assign_homologs_by_scores(allow_overlap=allow_overlap)
        self._determine_selection_changes(change_th=change_th)

    def iterative_assignment(self, max_niter: int = 10,
                             min_spot_num: int = 2,
                             change_shrink: float = 0.8,
                             local_range: int = 5,
                             allow_overlap: bool = False,
                             change_th: float = 0.01,
                             filter_by_score: bool = True) -> "SpotPicker":
        """Full picking loop (reference _iterative_assignment,
        picker.py:441-478); one host read of the change fractions an
        iteration."""
        if not self.chr_2_homolog_hzxys:
            self.first_assignment(min_spot_num=min_spot_num,
                                  local_range=local_range,
                                  allow_overlap=allow_overlap)
            if not self.chr_2_homolog_hzxys:
                return self
        self.n_iterations = 0
        for _ in range(max_niter):
            self.update_assignment(change_shrink=change_shrink,
                                   local_range=local_range,
                                   allow_overlap=allow_overlap,
                                   change_th=change_th)
            self.n_iterations += 1
            if not any(self.chr_2_change.values()):
                break
        if filter_by_score:
            self._filter_selected_by_scores()
        return self

    # -- outputs -----------------------------------------------------------

    def picked_table(self, filtered: bool = True) -> Table:
        """Long picked table: one row per (chr, homolog, region) with the
        picked hzxy, source row index (-1 where none) and chr_order."""
        src = (self.chr_2_filtered_hzxys if filtered and
               hasattr(self, "chr_2_filtered_hzxys")
               else self.chr_2_homolog_hzxys)
        inds = (self.chr_2_filtered_inds if filtered and
                hasattr(self, "chr_2_filtered_inds")
                else self.chr_2_homolog_inds)
        cols = {k: [] for k in ("chr", "homolog", "chr_order",
                                "center_intensity", "center_z", "center_x",
                                "center_y", "coord_index")}
        for chrom, picked in src.items():
            p = np.asarray(picked.cpu() if isinstance(picked, torch.Tensor)
                           else picked, np.float64)
            ix = np.asarray(inds[chrom].cpu() if isinstance(
                inds[chrom], torch.Tensor) else inds[chrom], np.int64)
            h, r = np.indices(p.shape[:2])
            cols["chr"].append(np.full(h.size, chrom))
            cols["homolog"].append(h.ravel())
            cols["chr_order"].append(r.ravel())
            for k, c in enumerate(("center_intensity", "center_z",
                                   "center_x", "center_y")):
                cols[c].append(p[..., k].ravel())
            cols["coord_index"].append(ix.ravel())
        if not src:
            return {}
        return {c: np.concatenate(v) for c, v in cols.items()}

    def picked_dataframe(self, filtered: bool = True):
        """:meth:`picked_table` as a DataFrame (imports pandas)."""
        return to_dataframe(self.picked_table(filtered))

    def save_picked(self, path: Optional[str] = None) -> None:
        """Persist picked results under a `picked/` group (reference
        _save_picked, picker.py:480-516): h5py datasets, or ``.npy``
        files where h5py is missing (or `path` is a directory)."""
        path = path or self.save_file
        if not path:
            raise ValueError("no save_file configured")
        with open_table_file(path, "a") as fh:
            for sub, d in [
                    ("chr_2_homolog_hzxys", self.chr_2_homolog_hzxys),
                    ("chr_2_homolog_inds", self.chr_2_homolog_inds),
                    ("chr_2_homolog_centers", self.chr_2_homolog_centers),
                    ("chr_2_scores", self.chr_2_scores),
                    ("chr_2_filtered_hzxys",
                     getattr(self, "chr_2_filtered_hzxys", {})),
                    ("chr_2_filtered_inds",
                     getattr(self, "chr_2_filtered_inds", {})),
                    ("chr_2_copyNum",
                     {c: np.array([n]) for c, n in
                      (self.chr_2_copy_num or {}).items()})]:
                grp = fh.require_group(f"picked/{sub}")
                for key, arr in d.items():
                    if key in grp:
                        del grp[key]
                    host = (arr.cpu().numpy() if isinstance(arr, torch.Tensor)
                            else np.asarray(arr))
                    grp.create_dataset(str(key), data=host)
            write_table(fh, "picked/merged_codebook", self.merged_codebook)
            write_table(fh, "picked/merged_coords", self.merged_coords)

    @classmethod
    def load_picked(cls, path: str, device=None) -> "SpotPicker":
        """Rehydrate a saved picker (reference _load_picked,
        picker.py:517-538), its arrays as tensors on `device`."""
        self = cls(device=device)
        dev = self.device
        with open_table_file(path, "r") as fh:
            def rd(sub):
                if f"picked/{sub}" not in fh:
                    return {}
                grp = fh[f"picked/{sub}"]
                return {k: grp[k][:] for k in grp.keys()}
            for sub in ("chr_2_homolog_hzxys", "chr_2_homolog_inds",
                        "chr_2_homolog_centers", "chr_2_scores",
                        "chr_2_filtered_hzxys", "chr_2_filtered_inds"):
                setattr(self, sub, {k: torch.as_tensor(v, device=dev)
                                    for k, v in rd(sub).items()})
            self.chr_2_copy_num = {k: int(v[0]) for k, v in
                                   rd("chr_2_copyNum").items()}
            self.merged_codebook = read_table(fh, "picked/merged_codebook")
            self.merged_coords = read_table(fh, "picked/merged_coords")
        return self


def batch_pick_spots(decoded_file: str, picked_file: str,
                     num_expected_lib: Optional[int] = None,
                     weights: Sequence[float] = DEFAULT_WEIGHTS,
                     score_th: float = DEFAULT_SCORE_TH,
                     max_niter: int = 10,
                     **picker_kwargs) -> Optional[SpotPicker]:
    """Decoded file -> picked file (reference batch_pick_spots,
    classes/picker.py:539-558): bail out unless the expected number of
    libraries is present, then run the full iterative assignment and
    save."""
    with open_table_file(decoded_file, "r") as fh:
        n_lib = len([k for k in fh.keys() if k != "picked"])
    if num_expected_lib is not None and n_lib != num_expected_lib:
        return None
    picker = SpotPicker(decoded_file=decoded_file,
                        metric_weights=weights,
                        valid_score_th=score_th,
                        save_file=picked_file, **picker_kwargs)
    picker.iterative_assignment(max_niter=max_niter)
    if picker.chr_2_homolog_hzxys and n_rows(picker.merged_coords) > 0:
        picker.save_picked()
    return picker
