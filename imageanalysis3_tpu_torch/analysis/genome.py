"""Genome-wide (multi-chromosome) distance summaries and interactions.

The counterpart of ``imageanalysis3_tpu/analysis/genome.py``.  Behavior
targets (reference ImageAnalysis3): per-chromosome-pair summary distances
(structure_tools/distance.py:12-123), chromosome sort key and plot order
(:125-162), matrix assembly and chromosome edges (:164-229), contact
probability (:231-232), merged cell coordinates
(figure_tools/plot_decode.py:110-143), multi-way interaction groups
(structure_tools/contact.py:3-34), per-homolog density clouds
(structure_tools/chromosome.py:5-57).

A codebook is a column mapping (``id``, ``chr``, ``chr_order``), as in
``io/spots.py``; a pandas DataFrame is a mapping of its columns too, so no
pandas is imported.  Each chromosome's traces across cells are stacked
once on the device; a chromosome pair's per-cell homolog distance maps
are one gather of those stacks, reduced by the averaging NaN median of
``ops.filters.nanquantile`` one pair at a time.  The interaction search is
a radius search on the device: squared float64 distances summed over the
axes in order against r^2, as scipy's ``cKDTree`` tests a ball; groups are
host sets, as in the JAX package.  Density clouds use
``compartments.spots_to_density``.
"""

from __future__ import annotations

import warnings
from itertools import combinations_with_replacement
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..decode.scoring import norm
from ..device import as_tensor, host_array, resolve_device
from ..ops.filters import nanquantile

f32 = torch.float32
f64 = torch.float64


def _col(codebook: Mapping, name: str) -> np.ndarray:
    return np.asarray(codebook[name])


# ---------------------------------------------------------------------------
# Chromosome ordering
# ---------------------------------------------------------------------------


def sort_chr(name: str) -> int:
    """Sort key for chromosome names: numeric order, then X=23, Y=24,
    anything else 25."""
    try:
        return int(name)
    except (TypeError, ValueError):
        pass
    if name == "X":
        return 23
    if name == "Y":
        return 24
    return 25


def _sorted_chrs(names) -> List[str]:
    return sorted((str(n) for n in np.unique(np.asarray(names, dtype=object))),
                  key=lambda c: (sort_chr(c), c))


# ---------------------------------------------------------------------------
# Pairwise summary distances
# ---------------------------------------------------------------------------


class _Stacks:
    """Each chromosome's homolog traces of every cell, stacked on the
    device: ``traces[c]`` (S_c, R_c, 3) float32, ``count[c]`` and
    ``offset[c]`` (n_cells,) the rows of each cell."""

    def __init__(self, chr_2_zxys_list, chrs, device):
        self.traces, self.count, self.offset = {}, {}, {}
        n = len(chr_2_zxys_list)
        for c in chrs:
            arrs = [np.asarray(cell[c], np.float32) if cell.get(c) is not None
                    else np.zeros((0, 0, 3), np.float32)
                    for cell in chr_2_zxys_list]
            cnt = np.asarray([len(a) for a in arrs], np.int64)
            self.count[c] = cnt
            self.offset[c] = np.concatenate([[0], np.cumsum(cnt)[:-1]]) \
                if n else cnt
            kept = [a for a in arrs if len(a)]
            self.traces[c] = (as_tensor(np.concatenate(kept), device)
                              if kept else None)

    def pairs(self, c1: str, c2: str, same_cell_distinct: bool = False):
        """Row indices (a into c1's stack, b into c2's) of every homolog
        pair of every cell holding both, cell by cell; with
        `same_cell_distinct` (c1 == c2) the ordered pairs a != b."""
        n1, n2 = self.count[c1], self.count[c2]
        m1, m2 = int(n1.max(initial=0)), int(n2.max(initial=0))
        i = np.arange(m1)[None, :, None]
        j = np.arange(m2)[None, None, :]
        ok = (i < n1[:, None, None]) & (j < n2[:, None, None])
        if same_cell_distinct:
            ok &= i != j
        a = np.broadcast_to(self.offset[c1][:, None, None] + i, ok.shape)[ok]
        b = np.broadcast_to(self.offset[c2][:, None, None] + j, ok.shape)[ok]
        return a, b


def _reduce(stack: torch.Tensor, function, axis):
    if function == "nanmedian":
        return nanquantile(stack, 0.5, dim=axis)
    if isinstance(function, str):
        function = getattr(np, function)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN slices
        out = function(host_array(stack).astype(np.float32), axis=axis)
    return torch.as_tensor(np.asarray(out), device=stack.device)


def _summarize(stacks: _Stacks, c1: str, c2: str, chr_sizes, function,
               axis, dev) -> Dict:
    def cross(a_idx, b_idx, ta, tb):
        if len(a_idx) == 0:
            return None
        a = ta[torch.as_tensor(a_idx, device=ta.device)]
        b = tb[torch.as_tensor(b_idx, device=tb.device)]
        return _reduce(norm(a[:, :, None, :] - b[:, None, :, :]),
                       function, axis)

    def empty(r1, r2):
        return torch.full((chr_sizes[r1], chr_sizes[r2]), float("nan"),
                          dtype=f32, device=dev)

    t1, t2 = stacks.traces[c1], stacks.traces[c2]
    out: Dict = {}
    if c1 != c2:
        red = cross(*stacks.pairs(c1, c2), t1, t2) if t1 is not None \
            and t2 is not None else None
        out[(c1, c2)] = empty(c1, c2) if red is None else red
        return out
    if t1 is None:
        out[f"cis_{c1}"] = out[f"trans_{c1}"] = empty(c1, c1)
        return out
    rows = np.arange(t1.shape[0])
    out[f"cis_{c1}"] = cross(rows, rows, t1, t1)
    red = cross(*stacks.pairs(c1, c1, same_cell_distinct=True), t1, t1)
    out[f"trans_{c1}"] = empty(c1, c1) if red is None else red
    return out


def summarize_chr_pair(chr_2_zxys_list: Sequence[Dict[str, np.ndarray]],
                       c1: str, c2: str, chr_sizes: Dict[str, int],
                       function="nanmedian", axis=0, device=None) -> Dict:
    """Summary distances for one chromosome pair across cells.
    chr_2_zxys_list: per-cell dicts chr -> (H, R_chr, 3) homolog traces.
    Same-chromosome pairs give ``cis_<chr>`` (per-homolog maps) and
    ``trans_<chr>`` (ordered homolog permutations); distinct chromosomes
    one ``(c1, c2)`` entry over all homolog cross pairs; pairs never
    observed are all-NaN blocks sized from ``chr_sizes``.  float32 on
    `device` (default the card)."""
    dev = resolve_device(device)
    c1, c2 = str(c1), str(c2)
    stacks = _Stacks(chr_2_zxys_list, sorted({c1, c2}), dev)
    return _summarize(stacks, c1, c2, chr_sizes, function, axis, dev)


def genome_summary_dict(chr_2_zxys_list: Sequence[Dict[str, np.ndarray]],
                        codebook: Mapping, function="nanmedian", axis=0,
                        device=None) -> Dict:
    """All-pairs summary distance dictionary, the chromosomes in sorted
    order; each chromosome's traces are stacked on the device once."""
    dev = resolve_device(device)
    chrs = _sorted_chrs(_col(codebook, "chr"))
    names = _col(codebook, "chr").astype(str)
    sizes = {c: int(np.sum(names == c)) for c in chrs}
    stacks = _Stacks(chr_2_zxys_list, chrs, dev)
    summary: Dict = {}
    for c1, c2 in combinations_with_replacement(chrs, 2):
        summary.update(_summarize(stacks, c1, c2, sizes, function, axis,
                                  dev))
    return summary


# ---------------------------------------------------------------------------
# Plot order + matrix assembly
# ---------------------------------------------------------------------------


def generate_plot_order(total_codebook: Mapping,
                        sel_codebook: Optional[Mapping] = None,
                        sort_by_region: bool = True,
                        ) -> Tuple[Dict[str, np.ndarray],
                                   Dict[str, np.ndarray]]:
    """Each chromosome's row indices in the assembled matrix and its
    within-chromosome region orders."""
    if sel_codebook is None:
        sel_codebook = total_codebook
    chr_2_plot_indices: Dict[str, np.ndarray] = {}
    chr_2_chr_orders: Dict[str, np.ndarray] = {}
    first = {}                  # each selected id's first row
    for row, rid in enumerate(_col(sel_codebook, "id").tolist()):
        first.setdefault(rid, row)
    tot_chr = _col(total_codebook, "chr").astype(str)
    tot_ids = _col(total_codebook, "id")
    tot_orders = _col(total_codebook, "chr_order")
    n_sel = 0
    for chrom in _sorted_chrs(_col(total_codebook, "chr")):
        inds, orders = [], []
        for rid, order in zip(tot_ids[tot_chr == chrom].tolist(),
                              tot_orders[tot_chr == chrom].tolist()):
            if rid in first:
                inds.append(first[rid])
                orders.append(int(order))
        if not inds:
            continue
        if sort_by_region:
            chr_2_plot_indices[chrom] = np.asarray(inds)
            chr_2_chr_orders[chrom] = np.asarray(orders)
        else:
            chr_2_plot_indices[chrom] = np.arange(n_sel, n_sel + len(inds))
            chr_2_chr_orders[chrom] = np.arange(len(inds))
        n_sel += len(inds)
    return chr_2_plot_indices, chr_2_chr_orders


def generate_plot_chr_edges(sel_codebook: Mapping,
                            chr_2_plot_inds: Optional[Dict] = None,
                            sort_by_region: bool = True,
                            ) -> Tuple[np.ndarray, List[str]]:
    """Chromosome block edges and labels along the assembled matrix axis."""
    if chr_2_plot_inds is None or not isinstance(chr_2_plot_inds, dict):
        chr_2_plot_inds, _ = generate_plot_order(
            sel_codebook, sel_codebook, sort_by_region=sort_by_region)
    names_col = _col(sel_codebook, "chr").astype(str)
    edges: List[int] = []
    names: List[str] = []
    if sort_by_region:
        prev = None
        for pos, chrom in enumerate(names_col):
            if chrom != prev:
                edges.append(pos)
                names.append(chrom)
            prev = chrom
    else:
        for chrom, inds in chr_2_plot_inds.items():
            edges.append(int(inds[0]))
            names.append(chrom)
    edges.append(len(names_col))
    return np.asarray(edges), names


def assemble_dist_dict_to_matrix(dist_dict: Dict, total_codebook: Mapping,
                                 sel_codebook: Optional[Mapping] = None,
                                 use_cis: bool = True,
                                 use_trans: bool = False,
                                 sort_by_region: bool = True, device=None,
                                 ) -> Tuple[torch.Tensor, np.ndarray,
                                            List[str]]:
    """A genome-wide float32 matrix from a summary dict: diagonal blocks
    the cis (or trans) maps, off-diagonal blocks the inter-chromosome map
    in either key order, placed through the plot order."""
    dev = resolve_device(device)
    if sel_codebook is None:
        sel_codebook = total_codebook
    plot_inds, chr_orders = generate_plot_order(
        total_codebook, sel_codebook, sort_by_region=sort_by_region)
    n = len(_col(sel_codebook, "id"))
    matrix = torch.full((n, n), float("nan"), dtype=f32, device=dev)
    chrs = [c for c in _sorted_chrs(_col(total_codebook, "chr"))
            if c in plot_inds]
    t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
    blk = lambda k: as_tensor(dist_dict[k], dev).to(f32)
    for c1 in chrs:
        i1, o1 = t(plot_inds[c1]), t(chr_orders[c1])
        for c2 in chrs:
            i2, o2 = t(plot_inds[c2]), t(chr_orders[c2])
            if c1 == c2:
                if use_cis and f"cis_{c1}" in dist_dict:
                    block = blk(f"cis_{c1}")
                elif use_trans and f"trans_{c1}" in dist_dict:
                    block = blk(f"trans_{c1}")
                else:
                    continue
                matrix[i1[:, None], i2] = block[o1[:, None], o2]
            elif (c1, c2) in dist_dict:
                block = blk((c1, c2))[o1[:, None], o2]
                matrix[i1[:, None], i2] = block
                matrix[i2[:, None], i1] = block.T
            elif (c2, c1) in dist_dict:
                block = blk((c2, c1))[o2[:, None], o1]
                matrix[i1[:, None], i2] = block.T
                matrix[i2[:, None], i1] = block
    edges, names = generate_plot_chr_edges(sel_codebook, plot_inds,
                                           sort_by_region)
    return matrix, edges, names


def contact_prob(mat, contact_th: float = 0.6, axis: int = 0,
                 device=None) -> torch.Tensor:
    """Fraction of finite entries at or below the contact threshold along
    `axis` (float64, as NumPy divides the counts)."""
    mat = as_tensor(mat, device).to(f32)
    finite = torch.isfinite(mat)
    hits = ((mat <= contact_th) & finite).sum(dim=axis).to(f64)
    return hits / finite.sum(dim=axis).to(f64)


# ---------------------------------------------------------------------------
# Merged cell coordinates + multi-way interactions
# ---------------------------------------------------------------------------


def center_chr_traces(chr_2_zxys: Dict[str, np.ndarray], device=None
                      ) -> Dict[str, torch.Tensor]:
    """Subtract the cell's whole-genome NaN-mean position from every
    homolog trace (float32)."""
    dev = resolve_device(device)
    traces = {c: as_tensor(np.asarray(z, np.float32), dev)
              for c, z in chr_2_zxys.items()}
    pooled = torch.cat([z.reshape(-1, 3) for z in traces.values()])
    ok = ~torch.isnan(pooled)
    center = torch.where(ok, pooled, 0.0).sum(dim=0) / ok.sum(dim=0)
    return {c: z - center for c, z in traces.items()}


def merge_chr_traces(chr_2_zxys: Dict[str, np.ndarray], codebook: Mapping,
                     keep_valid: bool = False, device=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every homolog trace flattened into one (N, 3) float32 tensor with
    its (N,) int64 region indices in chromosome-sorted plot order; with
    `keep_valid` only the fully finite rows."""
    dev = resolve_device(device)
    plot_inds, _ = generate_plot_order(codebook, codebook,
                                       sort_by_region=False)
    zxys, rids = [], []
    for chrom, inds in plot_inds.items():
        if chrom not in chr_2_zxys:
            continue
        tr = chr_2_zxys[chrom]
        tr = host_array(tr) if isinstance(tr, torch.Tensor) else tr
        tr = np.asarray(tr, np.float32)
        zxys.append(tr.reshape(-1, 3))
        rids.append(np.tile(np.asarray(inds, np.int64), tr.shape[0]))
    z = torch.as_tensor(np.concatenate(zxys), device=dev)
    r = torch.as_tensor(np.concatenate(rids), device=dev)
    if keep_valid:
        ok = torch.isfinite(z).all(dim=1)
        z, r = z[ok], r[ok]
    return z, r


def find_interaction_groups(chr_2_zxys: Dict[str, np.ndarray],
                            codebook: Mapping, search_radius: float = 0.5,
                            min_chrs: int = 3, device=None,
                            ) -> Tuple[List[np.ndarray], List[np.ndarray],
                                       List[np.ndarray]]:
    """Multi-way trans-chromosome contact hubs of one cell: the ball of
    every locus (float64 squared distances <= r^2, as a KD-tree's ball
    query tests them) with at least min(min_chrs, 3) members is a
    candidate; a candidate whose members are pairwise within
    `search_radius` (float32 distances, strictly) and span >= `min_chrs`
    chromosomes is kept.  Returns (coords, region ids, chr names) per
    group, in sorted group order, as NumPy."""
    zxys, rids = merge_chr_traces(chr_2_zxys, codebook, keep_valid=True,
                                  device=device)
    chr_per_region = _col(codebook, "chr").astype(str)
    if zxys.shape[0] == 0:
        return [], [], []
    z64 = zxys.to(f64)
    d = z64[:, None, :] - z64[None, :, :]
    ball = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
            + d[..., 2] * d[..., 2]) <= float(search_radius) ** 2
    del d
    rows = torch.nonzero(ball.sum(dim=1) >= min(int(min_chrs), 3))[:, 0]
    if rows.numel() == 0:
        return [], [], []
    members = host_array(ball[rows])
    groups = {tuple(np.nonzero(m)[0]) for m in members}
    used = np.unique(np.concatenate([np.asarray(g) for g in groups]))
    used_t = torch.as_tensor(used, device=zxys.device)
    sub = zxys[used_t]
    close = host_array(norm(sub[:, None, :] - sub[None, :, :])
                       < np.float32(search_radius))
    pts_all = host_array(sub)
    rids_all = host_array(rids[used_t])
    pos = {int(u): k for k, u in enumerate(used)}
    coords_out, rids_out, chrs_out = [], [], []
    for g in sorted(groups):
        loc = np.asarray([pos[int(i)] for i in g])
        if not close[np.ix_(loc, loc)][np.triu_indices(len(loc), 1)].all():
            continue
        g_rids = rids_all[loc]
        g_chrs = chr_per_region[g_rids]
        if len(np.unique(g_chrs)) >= int(min_chrs):
            coords_out.append(pts_all[loc])
            rids_out.append(g_rids)
            chrs_out.append(g_chrs)
    return coords_out, rids_out, chrs_out


# ---------------------------------------------------------------------------
# Per-homolog density clouds
# ---------------------------------------------------------------------------


def chr_to_density_clouds(chr_2_zxys: Dict[str, np.ndarray],
                          pixel_size: float = 0.1,
                          im_radius: float = 5.0,
                          gaussian_sigma: float = 0.5,
                          allowed_homolog_num: Sequence[int] = (1, 2),
                          min_valid_spots: int = 20,
                          min_valid_per: float = 0.25,
                          normalize_counts: bool = False,
                          normalize_pdf: bool = False,
                          return_empty: bool = False, device=None,
                          ) -> Dict[str, torch.Tensor]:
    """Each chromosome's homolog traces as 3D Gaussian density grids
    around the cell centre -> chr -> (H_kept, G, G, G) float32 on a grid
    of extent 2 im_radius and voxel `pixel_size`; homologs failing the
    valid-spot screens render as zeros and are dropped unless
    `return_empty`.  The pdf of ``compartments.spots_to_density``, scaled
    to unit-height Gaussians (or per spot with `normalize_counts`)."""
    from .compartments import spots_to_density

    centered = center_chr_traces(chr_2_zxys, device=device)
    grid_radius = int(round(im_radius / pixel_size))
    g = 2 * grid_radius
    sigma_vox = float(gaussian_sigma) / float(pixel_size)
    allowed = set(int(h) for h in allowed_homolog_num)
    out: Dict[str, torch.Tensor] = {}
    for chrom, homologs in centered.items():
        if homologs.ndim != 3 or homologs.shape[0] not in allowed:
            continue
        ok = torch.isfinite(homologs).all(dim=2)
        n_ok = host_array(ok.sum(dim=1))
        frac = host_array(ok.to(f32).mean(dim=1))
        stack = torch.zeros((homologs.shape[0], g, g, g), dtype=f32,
                            device=homologs.device)
        for h in range(homologs.shape[0]):
            if n_ok[h] <= min_valid_spots or frac[h] < min_valid_per:
                continue
            dens = spots_to_density(homologs[h], ok[h],
                                    grid_radius=grid_radius,
                                    sigma=float(gaussian_sigma),
                                    voxel=float(pixel_size))
            raw_mass = int(n_ok[h]) * (2.0 * np.pi) ** 1.5 * sigma_vox ** 3
            if not normalize_pdf:
                dens = dens * (raw_mass / int(n_ok[h]) if normalize_counts
                               else raw_mass)
            stack[h] = dens
        kept = stack.flatten(1).ne(0).any(dim=1)
        if return_empty:
            out[chrom] = stack
        elif bool(kept.any()):
            out[chrom] = stack[kept]
    return out
