"""Matplotlib rendering of pipeline outputs (headless-safe).

The counterpart of ``imageanalysis3_tpu/figures/plots.py``: the same
figures from the same arithmetic.  Every input may be a NumPy array or a
tensor on any device; tensors come to the host through
``device.host_array`` before drawing.  All functions accept an optional
`ax`, return the matplotlib Axes, and never call plt.show() — callers
decide presentation (the reference mixes show/save inline).  matplotlib
is imported inside each function.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..device import host_array
from ._mpl import pyplot


def _host(x, dtype=None) -> np.ndarray:
    a = host_array(x)
    return a if dtype is None else np.asarray(a, dtype)


def plot_distance_map(distmap, ax=None, cmap: str = "seismic_r",
                      color_limits=(0, 1500), ticks=None,
                      tick_labels=None, title: Optional[str] = None,
                      colorbar: bool = True, figure_dpi: int = 150,
                      save_path: Optional[str] = None):
    """Render a chromosome distance map (reference plot_distance_map,
    figure_tools/distmap.py:17-155)."""
    plt = pyplot()
    dm = _host(distmap, float)
    if dm.shape[0] != dm.shape[1]:
        raise ValueError(f"distmap must be square, got {dm.shape}")
    if ax is None:
        _, ax = plt.subplots(figsize=(4, 4), dpi=figure_dpi)
    shown = np.clip(dm, min(color_limits), None)
    im = ax.imshow(shown, cmap=cmap, interpolation="nearest",
                   vmin=min(color_limits), vmax=max(color_limits))
    if ticks is None:
        step = max(int(2 * 10 ** np.floor(np.log10(max(len(dm), 1)))), 1)
        ticks = np.arange(0, len(dm), step)
    ax.set_xticks(ticks)
    ax.set_yticks(ticks)
    if tick_labels is not None:
        lbl = [tick_labels[i] for i in ticks]
        ax.set_xticklabels(lbl, rotation=60)
        ax.set_yticklabels(lbl)
    if title:
        ax.set_title(title, fontsize=8)
    if colorbar:
        plt.colorbar(im, ax=ax, shrink=0.8)
    if save_path:
        ax.figure.savefig(save_path, transparent=True)
    return ax


def plot_boundaries(distmap, starts: Sequence[int], ax=None,
                    line_color: str = "y", line_width: float = 1.5,
                    plot_limits=(0, 1000), figure_dpi: int = 150,
                    save_path: Optional[str] = None):
    """Distance map with domain boundaries drawn as step lines
    (reference figure_tools/domain.py plot_boundaries)."""
    dm = _host(distmap, float)
    ax = plot_distance_map(dm, ax=ax, color_limits=plot_limits,
                           colorbar=False, figure_dpi=figure_dpi)
    starts = sorted(int(s) for s in _host(starts).reshape(-1))
    bounds = starts + [len(dm)]
    for s0, s1 in zip(bounds[:-1], bounds[1:]):
        ax.plot([s0 - 0.5, s1 - 0.5, s1 - 0.5],
                [s0 - 0.5, s0 - 0.5, s1 - 0.5],
                color=line_color, linewidth=line_width)
        ax.plot([s0 - 0.5, s0 - 0.5, s1 - 0.5],
                [s0 - 0.5, s1 - 0.5, s1 - 0.5],
                color=line_color, linewidth=line_width)
    ax.set_xlim(-0.5, len(dm) - 0.5)
    ax.set_ylim(len(dm) - 0.5, -0.5)
    if save_path:
        ax.figure.savefig(save_path, transparent=True)
    return ax


def plot_projection(im, axis: int = 0, mode: str = "max",
                    ax=None, cmap: str = "gray", percentiles=(1, 99.5),
                    spots=None, figure_dpi: int = 150,
                    save_path: Optional[str] = None):
    """Project a 3D stack and render it, optionally with spot overlays
    (reference figure_tools/image.py:27-190)."""
    plt = pyplot()
    im = _host(im, float)
    proj = im.max(axis=axis) if mode == "max" else im.mean(axis=axis)
    vmin, vmax = np.percentile(proj, percentiles)
    if ax is None:
        _, ax = plt.subplots(figsize=(4, 4), dpi=figure_dpi)
    ax.imshow(proj, cmap=cmap, vmin=vmin, vmax=vmax)
    if spots is not None and len(spots):
        zxy = _host(spots)
        if zxy.ndim == 2 and zxy.shape[1] >= 4:
            zxy = zxy[:, 1:4]
        keep = [i for i in range(3) if i != axis]
        ax.plot(zxy[:, keep[1]], zxy[:, keep[0]], "r+", markersize=4,
                markeredgewidth=0.6)
    ax.set_axis_off()
    if save_path:
        ax.figure.savefig(save_path, transparent=True)
    return ax


def plot_spot_overlay(im, spots, valid=None, **kwargs):
    """Max projection with fitted spots marked (QC shorthand)."""
    spots = _host(spots)
    if valid is not None:
        spots = spots[_host(valid, bool)]
    return plot_projection(im, spots=spots, **kwargs)


def plot_decode_stats(groups, ax=None, figure_dpi: int = 150,
                      save_path: Optional[str] = None):
    """Decode statistics: groups per region id + tuple-size histogram
    (reference figure_tools/plot_decode.py:66+).  `groups`: the port's
    ``decode.merfish.SpotGroups`` (or anything with ``ok``, ``region``
    and ``n_spots``)."""
    plt = pyplot()
    ok = _host(groups.ok, bool)
    regions = _host(groups.region)[ok]
    n_spots = _host(groups.n_spots)[ok]
    if ax is None:
        fig, axes = plt.subplots(1, 2, figsize=(7, 3), dpi=figure_dpi)
    else:
        axes = ax
    uniq, cts = np.unique(regions, return_counts=True)
    axes[0].bar(uniq.astype(str), cts)
    axes[0].set_xlabel("region id")
    axes[0].set_ylabel("decoded groups")
    axes[0].tick_params(axis="x", rotation=90, labelsize=5)
    sizes, scts = np.unique(n_spots, return_counts=True)
    axes[1].bar(sizes.astype(str), scts)
    axes[1].set_xlabel("spots per tuple")
    if save_path:
        axes[0].figure.savefig(save_path, transparent=True)
    return axes


def plot_segmentation_labels(labels, z: Optional[int] = None,
                             ax=None, figure_dpi: int = 150,
                             spots=None, save_path: Optional[str] = None):
    """Label-volume slice with random label colors (reference
    figure_tools/plot_segmentation.py)."""
    plt = pyplot()
    lab = _host(labels)
    plane = lab[z] if (lab.ndim == 3 and z is not None) else \
        (lab.max(axis=0) if lab.ndim == 3 else lab)
    n = int(plane.max()) + 1
    rng = np.random.default_rng(0)
    lut = np.vstack([[0, 0, 0], rng.uniform(0.2, 1.0, (max(n - 1, 1), 3))])
    rgb = lut[np.clip(plane, 0, n - 1)]
    if ax is None:
        _, ax = plt.subplots(figsize=(4, 4), dpi=figure_dpi)
    ax.imshow(rgb)
    if spots is not None and len(spots):
        zxy = _host(spots)
        if zxy.shape[1] >= 4:
            zxy = zxy[:, 1:4]
        ax.plot(zxy[:, 2], zxy[:, 1], "w+", markersize=4,
                markeredgewidth=0.6)
    ax.set_axis_off()
    if save_path:
        ax.figure.savefig(save_path, transparent=True)
    return ax


def plot_cell_spot_counts(cell_spot_counts, ax=None,
                          expected_count: int = 60,
                          figure_dpi: int = 150,
                          cmap: str = "Spectral_r",
                          save_path: Optional[str] = None):
    """Per-(cell, bit) candidate-spot count matrix with a colorbar
    (reference plot_cell_spot_counts,
    figure_tools/plot_partition.py:8-50): rows are cells, columns are
    readout bits, color saturates at `expected_count`.  Feed it the
    counts from analysis/partition.py count_genes."""
    plt = pyplot()
    counts = np.atleast_2d(_host(cell_spot_counts))
    if ax is None:
        _, ax = plt.subplots(figsize=(4, 3), dpi=figure_dpi)
    im = ax.imshow(counts, cmap=cmap, vmin=0, vmax=expected_count,
                   aspect="auto", interpolation="nearest")
    ax.set_xlabel("Bit", fontsize=8, labelpad=1)
    ax.set_ylabel("Cell id", fontsize=8, labelpad=0)
    ax.tick_params("both", labelsize=8, width=0.5, length=2, pad=1)
    cbar = plt.colorbar(im, ax=ax, fraction=0.07, pad=0.05)
    cbar.set_label("CandSpots count", fontsize=7.5, labelpad=6,
                   rotation=270)
    cbar.ax.tick_params("both", labelsize=8, width=0.5, length=2, pad=1)
    if save_path:
        ax.figure.savefig(save_path, transparent=True)
    return ax


def plot_boundary_probability(region_ids, domain_start_lists, ax=None,
                              figure_dpi: int = 150,
                              save_path: Optional[str] = None):
    """Per-region probability of being a domain boundary across cells
    (reference plot_boundary_probability, figure_tools/domain.py:30-55):
    count how many cells call each region id a domain start (start 0 is
    the trivial boundary and is skipped), normalized by cell count."""
    plt = pyplot()
    x = _host(region_ids, int)
    y = np.zeros(len(x), float)
    for starts in domain_start_lists:
        for s in _host(starts).reshape(-1):
            if s > 0:
                y[x == int(s)] += 1
    y = y / max(len(domain_start_lists), 1)
    if ax is None:
        _, ax = plt.subplots(figsize=(10, 3), dpi=figure_dpi)
    ax.plot(x, y, color="tab:blue", label="probability")
    ax.set_xlim(x.min(), x.max())
    ax.set_xlabel("region id")
    ax.set_ylabel("boundary probability")
    ax.legend()
    if save_path:
        ax.figure.savefig(save_path, transparent=True)
    return ax


def plot_genome_wide_distance_map(chr_zxys_list, chr_names,
                                  chr_boundaries,
                                  color_limits=(0.0, 5.0),
                                  cmap: str = "seismic_r", ax=None,
                                  figure_dpi: int = 150,
                                  save_path: Optional[str] = None):
    """Genome-wide single-cell distance map with chromosome block lines
    and centered chromosome tick labels (reference GenomeWide_DistMap,
    figure_tools/distmap.py:111-153).

    chr_zxys_list: per-chromosome (R_chr, 3) traces in plot order
    (e.g. one homolog each, from analysis.merge_chr_traces);
    chr_boundaries: block edges as from analysis.generate_plot_chr_edges.
    NaN rows render as the gray missing color.
    """
    import matplotlib as mpl

    plt = pyplot()
    zxys = np.concatenate([_host(z, float) for z in chr_zxys_list])
    dm = np.linalg.norm(zxys[:, None] - zxys[None], axis=-1)
    cmap_obj = mpl.colormaps[cmap].copy()
    cmap_obj.set_bad((0.5, 0.5, 0.5))
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 5), dpi=figure_dpi)
    pf = ax.imshow(dm, cmap=cmap_obj, vmin=min(color_limits),
                   vmax=max(color_limits))
    ax.figure.colorbar(pf, ax=ax, label="pairwise distance")
    edges = _host(chr_boundaries, float)
    centers = (edges[1:] + edges[:-1]) / 2
    ax.set_xticks(centers)
    ax.set_xticklabels(chr_names, fontsize=6, rotation=60)
    ax.set_yticks(centers)
    ax.set_yticklabels(chr_names, fontsize=6)
    ax.hlines(edges - 0.5, 0, len(dm), color="black", linewidth=0.5)
    ax.vlines(edges - 0.5, 0, len(dm), color="black", linewidth=0.5)
    ax.set_xlim(0, len(dm))
    ax.set_ylim(len(dm), 0)
    n_kept = int(np.sum(~np.isnan(zxys).any(axis=1)))
    ax.set_title(f"kept_spots: {n_kept}")
    if save_path:
        ax.figure.savefig(save_path, transparent=True)
    return ax


def remove_cap(im, cap_th_per: float = 99.5,
               fill_nan: bool = True) -> np.ndarray:
    """Cap the brightest pixels at a percentile — display prep for
    saturation-heavy stacks (reference visual_tools.py:3317-3330).
    Returns a float64 host array, as the JAX package does."""
    out = _host(im, np.float64).copy()
    if 0 < cap_th_per < 100:
        finite = out[np.isfinite(out)]
        if finite.size:
            th = np.percentile(finite, cap_th_per)
            out[out > th] = np.nan if fill_nan else th
    return out


def extract_spot_crops(im, centers, radius: int = 10) -> np.ndarray:
    """(N, 2r+1, 2r+1, 2r+1) float64 host crops centered on each (z,x,y);
    voxels falling outside the image are filled with the crop median
    (reference visual_tools.py:2615-2677 visualize_fitted_spot_crops'
    crop step).  NaN centers are skipped (dropped from the output)."""
    im = _host(im)
    centers = np.atleast_2d(_host(centers, np.float64))
    if centers.shape[1] > 3:          # full spot rows -> zxy columns
        centers = centers[:, 1:4]
    centers = centers[np.all(np.isfinite(centers), axis=1)]
    side = 2 * radius + 1
    crops = np.empty((len(centers), side, side, side), np.float64)
    for n, ct in enumerate(np.round(centers).astype(np.int64)):
        lo = np.maximum(ct - radius, 0)
        hi = np.minimum(ct + radius + 1, im.shape)
        block = im[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]].astype(np.float64)
        crop = np.full((side, side, side), np.median(block))
        ins = lo - (ct - radius)
        crop[ins[0]:ins[0] + block.shape[0],
             ins[1]:ins[1] + block.shape[1],
             ins[2]:ins[2] + block.shape[2]] = block
        crops[n] = crop
    return crops


def plot_spot_crops(im, centers, radius: int = 10,
                    axis: int = 0, n_cols: int = 8, figure_dpi: int = 150,
                    cmap: str = "gray",
                    save_path: Optional[str] = None):
    """Panel grid of max-projected crops around fitted spots — the
    fit-QC figure (reference visualize_fitted_spot_crops /
    visualize_fitted_spot_images, visual_tools.py:2615-2712)."""
    crops = extract_spot_crops(im, centers, radius=radius)
    n = len(crops)
    if n == 0:
        return None
    plt = pyplot()
    n_cols = min(n_cols, n)
    n_rows = (n + n_cols - 1) // n_cols
    fig, axes = plt.subplots(n_rows, n_cols,
                             figsize=(1.2 * n_cols, 1.2 * n_rows),
                             dpi=figure_dpi, squeeze=False)
    for k in range(n_rows * n_cols):
        ax = axes[k // n_cols][k % n_cols]
        ax.set_axis_off()
        if k < n:
            ax.imshow(crops[k].max(axis=axis), cmap=cmap)
    fig.tight_layout(pad=0.2)
    if save_path:
        fig.savefig(save_path, transparent=True)
    return fig
