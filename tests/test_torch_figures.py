"""PyTorch port vs JAX package: ``figures/`` plots, 3D renders and
colormaps, headless (Agg).

Every case of tests/test_figures.py runs on the port (the files are
written, above 1000 bytes); then each ``plots`` and ``render3d`` function
is called by both packages on the same seeded NumPy inputs and the
artists' data are compared, not pixels: image arrays and colour limits,
line, scatter and bar data, tick positions and labels, at rtol 1e-6 and
exactly for integer data.  ``normalize_center_spots`` and
``spots_to_density`` are held to the JAX test's tolerances (PCA axes up
to a sign per axis: the function fixes none); colormap RGBA tables and
``normalize_color`` exactly.  Tensors passed to the port draw as their
host arrays.
"""

import os

import matplotlib
matplotlib.use("Agg", force=True)
import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from imageanalysis3_tpu import figures as JF
from imageanalysis3_tpu.decode.merfish import SpotGroups as JaxGroups
from imageanalysis3_tpu_torch import figures as FG
from imageanalysis3_tpu_torch.decode.merfish import SpotGroups

RTOL = 1e-6


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def _size(path) -> int:
    return os.path.getsize(path)


def _same(a, b, exact=False):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    if exact or a.dtype.kind in "iub":
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=RTOL, equal_nan=True)


def _ticks(ax):
    return ([t.get_text() for t in ax.get_xticklabels()],
            [t.get_text() for t in ax.get_yticklabels()],
            list(ax.get_xticks()), list(ax.get_yticks()))


def _same_axes(got, want):
    """Images (array, clim), lines, collections, bars and ticks of two
    2D axes."""
    assert len(got.images) == len(want.images)
    for g, w in zip(got.images, want.images):
        _same(g.get_array(), w.get_array())
        _same(g.get_clim(), w.get_clim())
    assert len(got.lines) == len(want.lines)
    for g, w in zip(got.lines, want.lines):
        _same(g.get_xdata(), w.get_xdata())
        _same(g.get_ydata(), w.get_ydata())
        assert g.get_color() == w.get_color()
    assert len(got.collections) == len(want.collections)
    for g, w in zip(got.collections, want.collections):
        if hasattr(g, "get_segments"):
            assert len(g.get_segments()) == len(w.get_segments())
            for sg, sw in zip(g.get_segments(), w.get_segments()):
                _same(sg, sw)
    assert len(got.patches) == len(want.patches)
    for g, w in zip(got.patches, want.patches):
        _same(g.get_height(), w.get_height())
    assert _ticks(got) == _ticks(want)
    assert got.get_title() == want.get_title()
    _same(got.get_xlim(), want.get_xlim())
    _same(got.get_ylim(), want.get_ylim())


def _distmap():
    rng = np.random.default_rng(0)
    dm = rng.uniform(100, 1200, (30, 30))
    dm = (dm + dm.T) / 2
    np.fill_diagonal(dm, 0)
    return dm


def _polymer_spots(n=40, seed=0, missing=(7, 8, 21)):
    rng = np.random.default_rng(seed)
    zxy = np.cumsum(rng.normal(0, 120, (n, 3)), axis=0)
    zxy -= zxy.mean(0)
    spots = np.column_stack([rng.uniform(500, 2000, n), zxy / 108.0])
    spots[list(missing)] = np.nan
    return spots


# ---------------------------------------------------------------------------
# tests/test_figures.py's cases, on the port
# ---------------------------------------------------------------------------


def test_plot_distance_map_and_boundaries(tmp_path):
    dm = _distmap()
    p1, p2 = str(tmp_path / "dm.png"), str(tmp_path / "bd.png")
    ax = FG.plot_distance_map(dm, save_path=p1)
    _same_axes(ax, JF.plot_distance_map(dm))
    bd = FG.plot_boundaries(dm, [0, 10, 20], save_path=p2)
    _same_axes(bd, JF.plot_boundaries(dm, [0, 10, 20]))
    assert _size(p1) > 1000 and _size(p2) > 1000
    # labelled ticks, a title, no colorbar
    kw = dict(tick_labels=[f"r{i}" for i in range(30)], title="cell 3",
              colorbar=False, color_limits=(200, 900))
    _same_axes(FG.plot_distance_map(dm, **kw),
               JF.plot_distance_map(dm, **kw))


def test_plot_projection_with_spots(tmp_path):
    rng = np.random.default_rng(1)
    im = rng.uniform(0, 100, (8, 32, 32))
    spots = np.zeros((3, 11))
    spots[:, 1:4] = [[4, 10, 10], [4, 20, 5], [4, 15, 25]]
    valid = np.array([True, True, False])
    p = str(tmp_path / "proj.png")
    ax = FG.plot_spot_overlay(im, spots, valid=valid, save_path=p)
    assert _size(p) > 1000
    _same_axes(ax, JF.plot_spot_overlay(im, spots, valid=valid))
    # a mean projection along x with zxy rows
    kw = dict(axis=1, mode="mean", percentiles=(5, 95))
    _same_axes(FG.plot_projection(im, spots=spots[:, 1:4], **kw),
               JF.plot_projection(im, spots=spots[:, 1:4], **kw))


def _groups(m):
    return dict(
        spot_idx=m(np.array([[0, 1, -1], [2, 3, 4], [5, 6, -1]], np.int32)),
        region=m(np.array([101, 102, 101], np.int32)),
        n_spots=m(np.array([2, 3, 2], np.int32)),
        ok=m(np.array([True, True, True])),
        spot_usage=m(np.zeros(7, np.int32)))


def test_plot_decode_stats_and_labels(tmp_path):
    groups = SpotGroups(**_groups(torch.as_tensor))
    p = str(tmp_path / "decode.png")
    axes = FG.plot_decode_stats(groups, save_path=p)
    want = JF.plot_decode_stats(JaxGroups(**_groups(jnp.asarray)))
    for g, w in zip(axes, want):
        _same_axes(g, w)
    labels = np.zeros((4, 16, 16), np.int32)
    labels[:, 2:8, 2:8] = 1
    labels[:, 9:14, 9:14] = 2
    p2 = str(tmp_path / "seg.png")
    ax = FG.plot_segmentation_labels(labels, save_path=p2)
    _same_axes(ax, JF.plot_segmentation_labels(labels))
    assert _size(p) > 1000 and _size(p2) > 1000
    spots = np.array([[1.0, 5.0, 5.0], [2.0, 11.0, 12.0]])
    _same_axes(FG.plot_segmentation_labels(torch.as_tensor(labels), z=1,
                                           spots=spots),
               JF.plot_segmentation_labels(labels, z=1, spots=spots))


def test_normalize_center_spots_pca():
    spots = _polymer_spots()
    out = FG.normalize_center_spots(spots, pca_align=True)
    valid = ~np.isnan(out).any(1)
    np.testing.assert_allclose(np.nanmean(out[valid], 0), 0, atol=1e-6)
    cov = np.cov(out[valid].T)
    off = cov - np.diag(np.diag(cov))
    assert np.abs(off).max() < 1e-6 * np.diag(cov).max()
    d = np.diag(cov)
    assert d[0] >= d[1] >= d[2]
    assert np.isnan(out[7]).all()


@pytest.mark.parametrize("kw", [
    dict(pca_align=True),
    dict(pca_align=True, scale_variance=True, scaling=2.0),
    dict(pca_align=False, center_zero=False),
    dict(pca_align=True, return_pca=True)])
def test_normalize_center_spots_matches_jax(kw):
    """Equal to JAX's on the same spots: the PCA axes up to a sign per
    axis (the function fixes none), the rest at rtol 1e-6."""
    spots = _polymer_spots(seed=4)
    got = FG.normalize_center_spots(torch.as_tensor(spots), **kw)
    want = JF.normalize_center_spots(spots, **kw)
    if kw.get("return_pca"):
        (got, gv), (want, wv) = got, want
        sign = np.sign(np.sum(gv * wv, axis=1))
        _same(gv * sign[:, None], wv)
    valid = ~np.isnan(want).any(1)
    assert (np.isnan(got).any(1) == ~valid).all()
    if kw.get("pca_align"):
        sign = np.sign(np.sum(got[valid] * want[valid], axis=0))
        got = got * sign[None]
    np.testing.assert_allclose(got[valid], want[valid], rtol=RTOL,
                               atol=1e-9)


def _same_3d(got, want):
    """Scatter offsets and colours, 3D line data, limits and view of two
    3D axes, both drawn (drawing depth-sorts a 3D scatter's colours)."""
    got.figure.canvas.draw()
    want.figure.canvas.draw()
    assert len(got.collections) == len(want.collections)
    for g, w in zip(got.collections, want.collections):
        for a, b in zip(g._offsets3d, w._offsets3d):
            _same(np.asarray(a), np.asarray(b))
        _same(g.get_facecolor(), w.get_facecolor())
    assert len(got.lines) == len(want.lines)
    for g, w in zip(got.lines, want.lines):
        for a, b in zip(g.get_data_3d(), w.get_data_3d()):
            _same(a, b)
        _same(matplotlib.colors.to_rgba(g.get_color()),
              matplotlib.colors.to_rgba(w.get_color()))
    for lim in ("get_xlim", "get_ylim", "get_zlim"):
        _same(getattr(got, lim)(), getattr(want, lim)())
    assert (got.elev, got.azim) == (want.elev, want.azim)


def test_chromosome_3d_rendering_smoke(tmp_path):
    spots = _polymer_spots()
    p = str(tmp_path / "trace3d.png")
    ax, cb = FG.chromosome_structure_3d_rendering(
        spots, image_radius=1500.0, save_path=p)
    assert _size(p) > 1000
    img = plt.imread(p)[..., :3]
    colored = ((img.max(-1) - img.min(-1)) > 0.08).sum()
    assert colored > 4000, f"only {colored} colored pixels rendered"
    jax_ax, jax_cb = JF.chromosome_structure_3d_rendering(
        spots, image_radius=1500.0)
    _same_3d(ax, jax_ax)
    _same((cb.vmin, cb.vmax), (jax_cb.vmin, jax_cb.vmax))
    colors = np.tile([[1.0, 0, 0], [0, 0, 1.0]], (20, 1))[:40]
    p2 = str(tmp_path / "trace3d_dom.png")
    ax2, cb2 = FG.chromosome_structure_3d_rendering(
        torch.as_tensor(spots), colors=colors, add_colorbar=False,
        save_path=p2)
    assert _size(p2) > 1000 and cb2 is None
    _same_3d(ax2, JF.chromosome_structure_3d_rendering(
        spots, colors=colors, add_colorbar=False)[0])
    kw = dict(pca_align=True, image_radius=None, view_elev_angle=30.0,
              view_azim_angle=45.0, line_search_dist=1)
    _same_3d(FG.chromosome_structure_3d_rendering(spots, **kw)[0],
             JF.chromosome_structure_3d_rendering(spots, **kw)[0])


def test_chromosome_3d_cloud(tmp_path):
    rng = np.random.default_rng(3)
    a = rng.normal([-800, -800, 0], 150, (25, 3))
    b = rng.normal([800, 800, 0], 150, (25, 3))
    zxy = np.concatenate([a, b])
    comp = {"A": np.arange(25), "B": np.arange(25, 50)}
    p = str(tmp_path / "cloud.png")
    ax, den = FG.visualize_chromosome_3d_cloud(
        zxy, comp, im_radius=16, voxel_nm=150.0, center=False,
        save_path=p, return_density=True)
    assert _size(p) > 1000
    ca = np.unravel_index(np.argmax(den["A"]), den["A"].shape)
    cb_ = np.unravel_index(np.argmax(den["B"]), den["B"].shape)
    assert ca[1] < 16 <= cb_[1]
    jax_ax, jax_den = JF.visualize_chromosome_3d_cloud(
        zxy, comp, im_radius=16, voxel_nm=150.0, center=False,
        return_density=True)
    for k in comp:
        _same(den[k], jax_den[k])
    _same_3d(ax, jax_ax)


@pytest.mark.parametrize("kw", [dict(), dict(im_radius=12, spot_sigma=1.5,
                                             voxel_nm=120.0)])
def test_spots_to_density_matches_jax(kw):
    rng = np.random.default_rng(8)
    zxy = rng.normal(0, 600, (40, 3))
    zxy[5] = np.nan
    got = FG.spots_to_density(torch.as_tensor(zxy), **kw)
    _same(got, JF.spots_to_density(zxy, **kw))
    assert got.dtype == np.float64
    assert not FG.spots_to_density(np.full((2, 3), np.nan), **kw).any()


def test_plot_cell_spot_counts(tmp_path):
    rng = np.random.default_rng(1)
    counts = rng.integers(0, 80, (12, 16))
    p = str(tmp_path / "partition.png")
    ax = FG.plot_cell_spot_counts(counts, expected_count=60, save_path=p)
    assert _size(p) > 1000
    _same_axes(ax, JF.plot_cell_spot_counts(counts, expected_count=60))


def test_colormap_helpers():
    src = plt.get_cmap("viridis")
    t = FG.transparent_cmap(src, N=64, max_alpha=0.8)
    assert t is not src
    cols = t(np.linspace(0, 1, 64))
    assert cols[0, 3] < 1e-6 and abs(cols[-1, 3] - 0.8) < 0.02
    assert src(1.0)[3] == 1.0
    g = FG.black_gradient((1.0, 0.5, 0.0))
    assert np.allclose(g(0.0)[:3], 0, atol=0.01)
    assert np.allclose(g(1.0)[:3], (1.0, 0.5, 0.0), atol=0.01)
    tg = FG.transparent_gradient((0.2, 0.4, 0.9))
    assert np.allclose(tg(0.3)[:3], (0.2, 0.4, 0.9), atol=0.01)
    assert tg(0.0)[3] < tg(1.0)[3]
    assert np.allclose(FG.myReds(1.0), (1, 0, 0, 1), atol=0.01)
    assert np.allclose(FG.myReds_r(0.0), (1, 0, 0, 1), atol=0.01)


@pytest.mark.parametrize("name", ["myReds", "myBlues", "myGreens",
                                  "myReds_r", "myBlues_r", "myGreens_r"])
def test_colormap_tables_equal_jax(name):
    """The lazily built ramps' RGBA tables are JAX's exactly, and one
    object per name."""
    got, want = getattr(FG, name), getattr(JF, name)
    np.testing.assert_array_equal(np.asarray(got.colors),
                                  np.asarray(want.colors))
    np.testing.assert_array_equal(got(np.linspace(0, 1, 300)),
                                  want(np.linspace(0, 1, 300)))
    assert getattr(FG, name) is got
    assert getattr(FG.color, name) is got


def test_colormap_helper_tables_equal_jax():
    for args in [("viridis",), ("magma", False, 32, 0.5)]:
        np.testing.assert_array_equal(
            FG.transparent_cmap(*args).colors,
            JF.transparent_cmap(*args).colors)
    for kw in [dict(), dict(num_colors=17, max_alpha=0.7, transparent=True)]:
        np.testing.assert_array_equal(
            FG.black_gradient((0.3, 0.9, 0.1), **kw).colors,
            JF.black_gradient((0.3, 0.9, 0.1), **kw).colors)
    np.testing.assert_array_equal(
        FG.transparent_gradient((0.2, 0.4, 0.9), 33, 0.6).colors,
        JF.transparent_gradient((0.2, 0.4, 0.9), 33, 0.6).colors)
    with pytest.raises(AttributeError):
        FG.myPurples


def test_normalize_color_clips_and_scales():
    m = np.array([[0.0, 5.0], [10.0, np.nan]])
    out = FG.normalize_color(m, vmin=2.0, vmax=8.0)
    assert out[0, 0] == 0.0 and out[1, 0] == 1.0
    assert abs(out[0, 1] - 0.5) < 1e-9
    assert np.isnan(out[1, 1])
    rng = np.random.default_rng(5)
    r = rng.normal(size=(6, 7))
    r[2, 3] = np.nan
    for kw in [dict(), dict(vmin=-0.5), dict(vmin=-1.0, vmax=0.7)]:
        np.testing.assert_array_equal(
            FG.normalize_color(torch.as_tensor(r), **kw),
            JF.normalize_color(r, **kw))


def test_remove_cap_and_spot_crops(tmp_path):
    rng = np.random.default_rng(11)
    im = rng.normal(100, 5, size=(12, 40, 40))
    im[3, 7, 9] = 10000.0
    capped = FG.remove_cap(im, 99.5)
    assert np.isnan(capped[3, 7, 9])
    capped2 = FG.remove_cap(torch.as_tensor(im), 99.5, fill_nan=False)
    assert capped2[3, 7, 9] <= np.percentile(im, 99.6)
    _same(capped, JF.remove_cap(im, 99.5), exact=True)
    _same(capped2, JF.remove_cap(im, 99.5, fill_nan=False), exact=True)

    centers = np.array([[5.2, 10.4, 20.1],
                        [1.0, 2.0, 38.0],
                        [np.nan, 3.0, 3.0]])
    crops = FG.extract_spot_crops(im, centers, radius=4)
    assert crops.shape == (2, 9, 9, 9)
    np.testing.assert_allclose(crops[0][4, 4, 4], im[5, 10, 20])
    assert np.isfinite(crops[1]).all()
    _same(crops, JF.extract_spot_crops(im, centers, radius=4), exact=True)
    rows = np.zeros((3, 11))
    rows[:, 1:4] = centers
    _same(FG.extract_spot_crops(torch.as_tensor(im), torch.as_tensor(rows),
                                radius=3),
          JF.extract_spot_crops(im, rows, radius=3), exact=True)

    fig = FG.plot_spot_crops(im, centers, radius=4,
                             save_path=str(tmp_path / "crops.png"))
    assert (tmp_path / "crops.png").exists()
    want = JF.plot_spot_crops(im, centers, radius=4)
    for g, w in zip(fig.axes, want.axes):
        _same_axes(g, w)
    assert FG.plot_spot_crops(im, np.full((1, 3), np.nan)) is None


def test_plot_boundary_probability_matches_jax(tmp_path):
    ids = np.arange(40)
    starts = [[0, 5, 12, 30], [0, 12, 20], np.array([0, 5, 30, 35])]
    p = str(tmp_path / "prob.png")
    ax = FG.plot_boundary_probability(torch.as_tensor(ids), starts,
                                      save_path=p)
    assert _size(p) > 1000
    _same_axes(ax, JF.plot_boundary_probability(ids, starts))
    np.testing.assert_allclose(ax.lines[0].get_ydata()[[5, 12, 30]],
                               [2 / 3, 2 / 3, 2 / 3])


def test_plot_genome_wide_distance_map_matches_jax(tmp_path):
    rng = np.random.default_rng(12)
    chrs = [rng.normal(0, 2.0, (n, 3)) for n in (7, 5, 9)]
    chrs[1][2] = np.nan
    edges = np.array([0, 7, 12, 21])
    names = ["1", "2", "X"]
    p = str(tmp_path / "genome.png")
    ax = FG.plot_genome_wide_distance_map(
        [torch.as_tensor(c) for c in chrs], names, edges, save_path=p)
    assert _size(p) > 1000
    _same_axes(ax, JF.plot_genome_wide_distance_map(chrs, names, edges))
    assert ax.get_title() == "kept_spots: 20"
