"""3D rendering of chromosome traces and compartment clouds.

The counterpart of ``imageanalysis3_tpu/figures/render3d.py``: the figure
module's own NumPy arithmetic (its ``normalize_center_spots`` and
``spots_to_density``, not ``analysis.compartments``'), copied.  Inputs
may be tensors on any device; they come to the host through
``device.host_array``.  matplotlib is imported inside the functions.

Behavior targets (reference ImageAnalysis3):
  * spot normalization       spot_tools/translating.py:12-100
    (normalize_center_spots: pixel->nm scaling, centering, variance
    scaling, PCA alignment)
  * trace 3D rendering       figure_tools/image.py:189-391
    (chromosome_structure_3d_rendering: genomic-position coloring,
    two-half connecting segments with gap skipping, reference scale bar,
    view angles, horizontal colorbar)
  * compartment 3D cloud     figure_tools/image.py:392-582
    (visualize_chromosome_3d_cloud: per-compartment density isosurface +
    2D projections)

Headless-safe matplotlib (Agg); every function accepts an optional axes,
returns it, and never calls plt.show().  PCA is plain numpy SVD (the
reference pulls in sklearn); the cloud surface is rendered as the
thresholded density's surface-voxel point cloud (scikit-image's
marching_cubes is not a dependency, and the QC purpose — "are the two
compartment clouds where they should be?" — is served identically).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..device import host_array
from ._mpl import pyplot

#: nm per pixel along (z, x, y) — reference global _distance_zxy
DEFAULT_DISTANCE_ZXY = (200.0, 108.0, 108.0)


def _extract_zxy(spots: np.ndarray,
                 distance_zxy: Sequence[float]) -> np.ndarray:
    """(N, 3|4|11) spot rows -> (N, 3) zxy in translating.py's
    convention (reference translating.py:28-47: 3 cols = already zxy,
    4 cols = hzxy, otherwise full fit rows with zxy at 1:4 scaled by
    the z-anisotropy factor distance_zxy/min)."""
    spots = np.asarray(host_array(spots), float)
    if spots.ndim != 2:
        raise ValueError(f"spots must be 2D, got {spots.shape}")
    if spots.shape[1] == 3:
        return spots.copy()
    if spots.shape[1] == 4:
        return spots[:, 1:4].copy()
    scale = np.asarray(distance_zxy, float)[:3]
    return spots[:, 1:4] * (scale / scale.min())[None]


def _spots_to_nm(spots: np.ndarray,
                 distance_zxy: Sequence[float]) -> np.ndarray:
    """Rendering-path unit convention (reference image.py:216-221):
    3 cols = already nm zxy; anything wider = pixel zxy at cols 1:4,
    scaled by the FULL distance_zxy into nm."""
    spots = np.asarray(host_array(spots), float)
    if spots.ndim != 2:
        raise ValueError(f"spots must be 2D, got {spots.shape}")
    if spots.shape[1] == 3:
        return spots.copy()
    return spots[:, 1:4] * np.asarray(distance_zxy, float)[None, :3]


def normalize_center_spots(spots: np.ndarray,
                           distance_zxy: Sequence[float]
                           = DEFAULT_DISTANCE_ZXY,
                           center_zero: bool = True,
                           scale_variance: bool = False,
                           pca_align: bool = True,
                           scaling: float = 1.0,
                           return_pca: bool = False):
    """Standardize fitted spots into a centered (optionally PCA-aligned)
    3D frame (reference normalize_center_spots,
    spot_tools/translating.py:12-100).  NaN rows pass through as NaN and
    are excluded from the center / variance / PCA estimates."""
    coords = _extract_zxy(spots, distance_zxy)
    valid = ~np.isnan(coords).any(axis=1)
    center = (np.nanmean(coords[valid], axis=0) if valid.any()
              else np.zeros(3))
    if center_zero:
        coords = coords - center
        center = np.zeros(3)
    if scale_variance and valid.any():
        total = np.sqrt(np.nanvar(coords[valid], axis=0).sum())
        if total > 0:
            coords = coords / total
    coords = coords * scaling
    components = np.eye(3)
    if pca_align and valid.sum() >= 3:
        clean = coords[valid] - center
        clean = clean - clean.mean(axis=0)
        # principal axes via SVD (rows of Vt, descending variance)
        _u, _s, vt = np.linalg.svd(clean, full_matrices=False)
        components = vt
        coords = (coords - center) @ vt.T + center
    if return_pca:
        return coords, components
    return coords


def chromosome_structure_3d_rendering(
        spots: np.ndarray,
        ax3d=None,
        cmap="Spectral",
        colors: Optional[np.ndarray] = None,
        distance_zxy: Sequence[float] = DEFAULT_DISTANCE_ZXY,
        center: bool = True,
        pca_align: bool = False,
        image_radius: Optional[float] = 2000.0,
        marker_size: float = 6.0,
        line_search_dist: int = 3,
        line_width: float = 1.0,
        line_alpha: float = 1.0,
        background_color=(0, 0, 0),
        view_elev_angle: float = 0.0,
        view_azim_angle: float = 90.0,
        add_reference_bar: bool = True,
        reference_bar_length: float = 1000.0,
        add_colorbar: bool = True,
        cbar_label: Optional[str] = None,
        figure_title: str = "",
        figure_dpi: int = 150,
        save_path: Optional[str] = None):
    """3D rendering of one chromosome trace
    (reference chromosome_structure_3d_rendering,
    figure_tools/image.py:189-391).

    Spots are colored along their genomic order via `cmap` — or pass
    `colors` (N, 3|4) explicitly (e.g. per-domain colors).  Consecutive
    valid spots are linked by a segment drawn in two halves, each half in
    its endpoint's color; a gap of up to `line_search_dist` missing
    spots is skipped over to the next valid one, as in the reference.
    `add_reference_bar` draws a `reference_bar_length`-nm scale bar.
    Returns (ax3d, colorbar-or-None).
    """
    import matplotlib
    from matplotlib import cm as mcm

    plt = pyplot()
    zxy = normalize_center_spots(_spots_to_nm(spots, distance_zxy),
                                 distance_zxy=distance_zxy,
                                 center_zero=center, scale_variance=False,
                                 pca_align=pca_align)
    n = len(zxy)
    valid = ~np.isnan(zxy).any(axis=1)
    if colors is None:
        cmap_obj = plt.get_cmap(cmap) if isinstance(cmap, str) else cmap
        colors = np.array([cmap_obj(t)[:4]
                           for t in np.linspace(0, 1, max(n, 2))])[:n]
    else:
        colors = np.asarray(host_array(colors), float)
        if len(colors) != n:
            raise IndexError("colors length must match number of spots")
        if colors.shape[1] == 3:
            colors = np.concatenate(
                [colors, np.ones((n, 1))], axis=1)
        cmap_obj = matplotlib.colors.ListedColormap(colors)
    if image_radius is None:
        radius = (np.nanmax(np.abs(zxy)) if valid.any() else 1.0) \
            + reference_bar_length
    else:
        radius = image_radius + reference_bar_length

    if ax3d is None:
        fig = plt.figure(figsize=(4, 4), dpi=figure_dpi)
        ax3d = fig.add_subplot(projection="3d")
    back = np.asarray(background_color, float)[:3]
    ax3d.set_facecolor(back)

    # scatter (plotted x=image x, y=image y, z=image z as the reference)
    ax3d.scatter(zxy[valid, 1], zxy[valid, 2], zxy[valid, 0],
                 c=colors[valid], s=marker_size, depthshade=False)

    # connecting segments, two halves, gap-skipping
    for i in range(n - 1):
        if not valid[i]:
            continue
        for j in range(1, line_search_dist + 1):
            if i + j >= n:
                break
            if valid[i + j]:
                a, b = zxy[i], zxy[i + j]
                mid = (a + b) / 2
                for p, q, c in ((a, mid, colors[i]),
                                (mid, b, colors[i + j])):
                    ax3d.plot([p[1], q[1]], [p[2], q[2]], [p[0], q[0]],
                              color=c, alpha=line_alpha,
                              linewidth=line_width)
                break

    if add_reference_bar:
        # scale bar in the view plane's lower edge (reference
        # image.py:316-338 places it by the view angles)
        azim = np.deg2rad(view_azim_angle % 360)
        elev = np.deg2rad(view_elev_angle % 360)
        start = np.array([-np.cos(elev),
                          -np.sin(azim) + np.sin(elev) * np.cos(azim),
                          np.cos(azim) + np.sin(elev) * np.sin(azim)
                          ]) * radius
        vec = np.array([0.0, -np.sin(azim), np.cos(azim)]) \
            * reference_bar_length
        end = start + vec
        ax3d.plot([start[1], end[1]], [start[2], end[2]],
                  [start[0], end[0]], color=1 - back, linewidth=2)

    cb = None
    if add_colorbar and valid.any():
        idx = np.where(valid)[0]
        norm = matplotlib.colors.Normalize(vmin=idx.min(),
                                           vmax=max(idx.max(), 1))
        mappable = mcm.ScalarMappable(cmap=cmap_obj, norm=norm)
        mappable.set_array(idx)
        cb = plt.colorbar(mappable, ax=ax3d, orientation="horizontal",
                          pad=0.01, shrink=1.0)
        if cbar_label:
            cb.set_label(cbar_label, fontsize=8, labelpad=1)

    ax3d.grid(False)
    ax3d.axis("off")
    if figure_title:
        ax3d.set_title(figure_title, fontsize=8)
    ax3d.view_init(elev=view_elev_angle, azim=view_azim_angle)
    for setter in (ax3d.set_xlim, ax3d.set_ylim, ax3d.set_zlim):
        setter([-radius, radius])
    if save_path:
        ax3d.figure.savefig(save_path, transparent=False)
    return ax3d, cb


def spots_to_density(zxy: np.ndarray,
                     im_radius: int = 30,
                     spot_sigma: float = 2.0,
                     voxel_nm: float = 100.0) -> np.ndarray:
    """Gaussian KDE of (already centered/normalized) spots on a
    (2r, 2r, 2r) voxel grid — the density behind the compartment cloud
    (reference convert_spots_to_cloud,
    compartment_tools/scoring.py, used by image.py:415-424).  Output is
    normalized so its mean over occupied space is ~1, matching the
    reference's cloud_thres=1 convention."""
    zxy = np.asarray(host_array(zxy), float)
    zxy = zxy[~np.isnan(zxy).any(axis=1)]
    side = 2 * im_radius
    grid = (np.arange(side) - im_radius + 0.5) * voxel_nm
    den = np.zeros((side, side, side))
    if len(zxy) == 0:
        return den
    s2 = 2.0 * (spot_sigma * voxel_nm) ** 2
    for c in zxy:
        dz = np.exp(-(grid - c[0]) ** 2 / s2)
        dx = np.exp(-(grid - c[1]) ** 2 / s2)
        dy = np.exp(-(grid - c[2]) ** 2 / s2)
        den += dz[:, None, None] * dx[None, :, None] * dy[None, None, :]
    pos = den[den > 1e-6]
    if pos.size:
        den = den / pos.mean()
    return den


def _surface_voxels(mask: np.ndarray) -> np.ndarray:
    """(K, 3) indices of mask voxels with at least one off-mask
    6-neighbor (the thresholded density's surface shell)."""
    interior = mask.copy()
    for ax in range(3):
        interior &= np.roll(mask, 1, axis=ax) & np.roll(mask, -1, axis=ax)
    return np.argwhere(mask & ~interior)


def visualize_chromosome_3d_cloud(
        spots: np.ndarray,
        comp_dict: Dict[str, Sequence[int]],
        color_dict: Optional[Dict[str, Sequence[float]]] = None,
        density_dict: Optional[Dict[str, np.ndarray]] = None,
        ax3d=None,
        im_radius: int = 30,
        distance_zxy: Sequence[float] = DEFAULT_DISTANCE_ZXY,
        center: bool = True,
        pca_align: bool = False,
        voxel_nm: float = 100.0,
        cloud_thres: float = 1.0,
        cloud_alpha: float = 0.6,
        elev_angle: float = 30.0,
        azim_angle: float = 120.0,
        figure_dpi: int = 150,
        save_path: Optional[str] = None,
        return_density: bool = False):
    """Per-compartment 3D density clouds of one chromosome
    (reference visualize_chromosome_3d_cloud,
    figure_tools/image.py:392-582): each compartment's spot subset is
    KDE'd onto a shared voxel grid and its `cloud_thres` level set is
    rendered (surface-voxel point cloud here — see module docstring).

    `comp_dict`: {name: region indices}; `color_dict`: {name: RGB(A)}.
    """
    plt = pyplot()
    zxy = normalize_center_spots(_spots_to_nm(spots, distance_zxy),
                                 distance_zxy=distance_zxy,
                                 center_zero=center, scale_variance=False,
                                 pca_align=pca_align)
    if color_dict is None:
        default = plt.get_cmap("tab10")
        color_dict = {k: default(i % 10)[:3]
                      for i, k in enumerate(comp_dict)}
    for k in comp_dict:
        if k not in color_dict:
            raise KeyError(f"compartment {k!r} has no color in color_dict")
    if density_dict is None:
        density_dict = {
            k: spots_to_density(zxy[np.asarray(host_array(idx), int)],
                                im_radius=im_radius, voxel_nm=voxel_nm)
            for k, idx in comp_dict.items()}
    if ax3d is None:
        fig = plt.figure(figsize=(4, 4), dpi=figure_dpi)
        ax3d = fig.add_subplot(projection="3d")
    for k, den in density_dict.items():
        shell = _surface_voxels(den >= cloud_thres)
        if not len(shell):
            continue
        nm = (shell - im_radius + 0.5) * voxel_nm
        ax3d.scatter(nm[:, 1], nm[:, 2], nm[:, 0],
                     color=color_dict[k], s=4, alpha=cloud_alpha,
                     depthshade=False, label=str(k))
    ax3d.view_init(elev=elev_angle, azim=azim_angle)
    lim = im_radius * voxel_nm
    for setter in (ax3d.set_xlim, ax3d.set_ylim, ax3d.set_zlim):
        setter([-lim, lim])
    ax3d.legend(fontsize=7, loc="upper right")
    if save_path:
        ax3d.figure.savefig(save_path, transparent=False)
    if return_density:
        return ax3d, density_dict
    return ax3d
