"""PyTorch port vs JAX package: the interactive curation tools
(``SpotBrowser``, ``BoundaryMarker``) driven headless (Agg).

Every case of tests/test_interactive.py runs on the port, on the same
synthesized matplotlib events, with ``device="cpu"``.  Then: ``seed_view``
on the same stack and view gives JAX's seeds exactly; ``fit_view`` rows
equal JAX's at tests/test_torch_fit_entry.py's tolerances (centres and
widths within 1e-3 px, heights rtol 1e-2); a browser's and a marker's
``.npz`` written by one package loads in the other, both ways; the
browser raises without a card when no device is given.
"""

import matplotlib
matplotlib.use("Agg", force=True)
import matplotlib.pyplot as plt
from matplotlib.backend_bases import MouseButton, MouseEvent
import numpy as np
import pytest
import torch

from imageanalysis3_tpu import synthetic as jsyn
from imageanalysis3_tpu.figures import interactive as JI
from imageanalysis3_tpu_torch.figures import BoundaryMarker, SpotBrowser

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def _browser(ims, **kw):
    return SpotBrowser(ims, device="cpu", **kw)


def _spot_stack(shape=(8, 48, 48), centers=None):
    if centers is None:
        centers = np.array([[4.0, 15.0, 20.0], [4.0, 33.0, 30.0]])
    heights = np.full(len(centers), 4000.0)
    sigmas = np.tile([1.5, 1.6, 1.6], (len(centers), 1))
    im = jsyn.render_gaussian_spots(shape, centers, heights, sigmas,
                                    background=120.0)
    return np.asarray(im, np.float32), centers


def _right_click(browser, ax, xdata, ydata):
    """Dispatch a genuine right-click through the canvas pipeline."""
    px, py = ax.transData.transform((xdata, ydata))
    MouseEvent("button_press_event", browser.fig.canvas, px, py,
               button=MouseButton.RIGHT)._process()


def _fits_agree(a, b):
    """tests/test_torch_fit_entry.py's fit tolerances."""
    assert a.shape == b.shape
    np.testing.assert_allclose(a[:, 1:4], b[:, 1:4], atol=1e-3)
    np.testing.assert_allclose(a[:, 0], b[:, 0], rtol=1e-2)
    np.testing.assert_allclose(a[:, 5:8], b[:, 5:8], atol=1e-3)


# ---------------------------------------------------------------------------
# tests/test_interactive.py's cases, on the port
# ---------------------------------------------------------------------------


def test_spot_browser_click_add_and_delete():
    im, _ = _spot_stack()
    b = _browser([im, im * 0.5])
    b.fig.canvas.draw()
    _right_click(b, b.ax_xy, 20.0, 15.0)
    assert len(b.points) == 1
    z, x, y = b.points[0]
    assert abs(x - 15.0) < 1e-6 and abs(y - 20.0) < 1e-6
    assert 0 <= z <= im.shape[0]
    b.on_click(type("E", (), {"button": 3, "inaxes": b.ax_z,
                              "xdata": 20.0, "ydata": 6.0})())
    assert abs(b.points[0, 0] - 6.0) < 1e-6
    b.on_key(type("E", (), {"key": "shift"})())
    assert b.delete_mode
    _right_click(b, b.ax_xy, 20.0, 15.0)
    assert len(b.points) == 0
    b.on_key_release(type("E", (), {"key": "shift"})())
    assert not b.delete_mode


def test_spot_browser_image_cycling_scopes_points():
    im, _ = _spot_stack()
    b = _browser([im, im])
    b.add_point(4, 10, 10)
    b.on_key(type("E", (), {"key": "d"})())
    assert b.index_im == 1
    b.add_point(4, 20, 20)
    assert len(b.image_points(0)) == 1 and len(b.image_points(1)) == 1
    assert len(b._marks_xy.get_xdata()) == 1
    b.on_key(type("E", (), {"key": "a"})())
    assert b.index_im == 0


def test_spot_browser_seed_and_fit_recover_planted_spots():
    im, centers = _spot_stack()
    b = _browser([im], seed_kwargs=dict(max_num_seeds=8, th_seed=500.0,
                                        use_dynamic_th=False))
    seeds = b.seed_view()
    assert len(seeds) == 2
    rows = b.fit_view(radius=5)
    assert rows.shape[1] == 11
    got = rows[:, 1:4]
    for c in centers:
        err = np.abs(got - c).sum(axis=1).min()
        assert err < 0.2, (got, c)
    assert 0 in b.fits and len(b.fits[0]) == len(rows)


def test_spot_browser_autoscale_and_persistence(tmp_path):
    im, _ = _spot_stack()
    path = str(tmp_path / "picks.npz")
    b = _browser([im], save_file=path)
    b.add_point(4, 15, 20)
    lo, hi = b.autoscale()
    assert lo < hi
    b.fits[0] = np.zeros((1, 11), np.float32)
    b.save()
    b2 = _browser([im], save_file=path)
    assert len(b2.points) == 1
    assert np.allclose(b2.points[0], [4, 15, 20])
    assert 0 in b2.fits


def test_boundary_marker_click_records_diagonal_position():
    maps = [np.random.default_rng(0).uniform(0, 900, (40, 40))
            for _ in range(2)]
    m = BoundaryMarker(maps)
    m.fig.canvas.draw()
    px, py = m.ax.transData.transform((10.0, 14.0))
    MouseEvent("button_press_event", m.fig.canvas, px, py,
               button=MouseButton.RIGHT)._process()
    assert len(m.positions) == 1
    assert abs(m.positions[0] - 12.0) < 1e-6
    xs, ys = m.staircase()
    assert xs[0] == 0 and xs[-1] == 40
    assert np.isclose(xs, 12.0, atol=1e-5).any()
    assert np.isclose(ys, 12.0, atol=1e-5).any()


def test_boundary_marker_domain_starts_and_delete():
    m = BoundaryMarker([np.zeros((30, 30))])
    m.add_boundary(9.6, 10.0)
    m.add_boundary(20.0, 20.0)
    assert list(m.domain_starts()) == [0, 10, 20]
    m.delete_nearest(20.0, 20.0)
    assert list(m.domain_starts()) == [0, 10]
    m.pop_boundary()
    assert list(m.domain_starts()) == [0]


def test_boundary_marker_navigation_contrast_persistence(tmp_path):
    maps = [np.full((20, 20), float(i)) for i in range(25)]
    path = str(tmp_path / "bounds.npz")
    m = BoundaryMarker(maps, save_file=path)
    m.on_key(type("E", (), {"key": "e"})())
    assert m.index_im == 20
    m.on_key(type("E", (), {"key": "w"})())
    assert m.index_im == 0
    m.add_boundary(5.0, 5.0)
    m.on_key(type("E", (), {"key": "d"})())
    m.add_boundary(7.0, 9.0)
    assert len(m.boundaries(0)) == 1 and len(m.boundaries(1)) == 1
    m.scale(1.1)
    lo, hi = m._clim_memory[1]
    m2 = BoundaryMarker(maps, save_file=path)
    assert len(m2.boundaries(0)) == 1 and len(m2.boundaries(1)) == 1


def test_boundary_marker_autoscale_percentile():
    rng = np.random.default_rng(3)
    mp = rng.uniform(0, 1000, (50, 50))
    mp[0, 0] = np.nan
    m = BoundaryMarker([mp], scale_percentile=90.0)
    lo, hi = m.autoscale()
    vals = mp[np.isfinite(mp)]
    assert abs(lo - np.percentile(vals, 10.0)) < 1e-9
    assert abs(hi - np.percentile(vals, 90.0)) < 1e-9


def test_spot_browser_mutations_persist_without_explicit_save(tmp_path):
    im, _ = _spot_stack()
    path = str(tmp_path / "picks.npz")
    b = _browser([im], save_file=path)
    b.add_point(4, 15, 20)
    assert len(_browser([im], save_file=path).points) == 1
    b.pop_point()
    assert len(_browser([im], save_file=path).points) == 0


def test_spot_browser_view_resets_on_image_size_change():
    im, _ = _spot_stack()
    b = _browser([im, im[:, :24, :24]])
    b.set_image(1)
    assert b.ax_xy.get_xlim() == (-0.5, 23.5)
    b.set_image(0)
    assert b.ax_xy.get_xlim() == (-0.5, 47.5)


def test_boundary_marker_npz_loads_without_pickle(tmp_path):
    path = str(tmp_path / "bnd.npz")
    m = BoundaryMarker([np.eye(20)], names=["chr1"], save_file=path)
    m.add_boundary(4.2, 4.8)
    data = np.load(path)
    assert list(data["positions"]) == [4.5]
    assert str(data["names"][0]) == "chr1"


# ---------------------------------------------------------------------------
# against the JAX tools
# ---------------------------------------------------------------------------


def _field_stack():
    """Ten separated spots (>= 9 px apart) on a 10x64x64 stack with camera
    noise: no two compete for one fit (hazard 10)."""
    rng = np.random.default_rng(21)
    grid = np.stack(np.meshgrid([10.0, 30.0, 50.0], [10.0, 30.0, 50.0],
                                indexing="ij"), -1).reshape(-1, 2)
    xy = np.vstack([grid, [[40.0, 20.0]]]) + rng.uniform(-1.5, 1.5, (10, 2))
    centers = np.column_stack([rng.uniform(3, 7, 10), xy])
    heights = rng.uniform(1500, 4000, 10)
    sigmas = np.tile([1.4, 1.6, 1.6], (10, 1))
    im = jsyn.render_gaussian_spots((10, 64, 64), centers, heights, sigmas,
                                    background=150.0)
    im = np.asarray(im) + rng.normal(0, 15.0, im.shape)
    return im.astype(np.float32), centers


@pytest.mark.parametrize("view", [None, (20.5, 60.5, 50.5, 4.5)])
def test_seed_and_fit_view_match_jax(view):
    """The same stack, view and keyword arguments: seeds equal to JAX's,
    fitted rows at the fit tolerances, the same points and fits kept."""
    im, _ = _field_stack()
    kw = dict(seed_kwargs=dict(max_num_seeds=16, th_seed=400.0),
              fit_kwargs=dict(radius=4))
    got = _browser([im], **kw)
    want = JI.SpotBrowser([im], **kw)
    for b in (got, want):
        if view is not None:          # y_lo, y_hi, x_hi, x_lo
            b.ax_xy.set_xlim(view[0], view[1])
            b.ax_xy.set_ylim(view[2], view[3])
            b.set_image(0)
        b.add_point(5.0, 2.0, 2.0)    # kept by fit_view when out of view
    assert got.view_limits() == want.view_limits()
    s_got, s_want = got.seed_view(), want.seed_view()
    assert len(s_want) >= 2
    np.testing.assert_array_equal(s_got, s_want)
    np.testing.assert_array_equal(got.points, want.points)
    r_got, r_want = got.fit_view(), want.fit_view()
    _fits_agree(r_got, r_want)
    np.testing.assert_array_equal(got.point_image, want.point_image)
    np.testing.assert_allclose(got.points, want.points, atol=1e-3)
    _fits_agree(got.fits[0], want.fits[0])


def test_fit_view_takes_tensor_stacks_and_reuses_the_device_copy():
    """A tensor stack browses as its host copy, is its own device copy,
    and seeds and fits as the NumPy stack does; a NumPy stack's device copy
    is made once."""
    im, _ = _field_stack()
    kw = dict(seed_kwargs=dict(th_seed=400.0))
    t = torch.as_tensor(im)
    b = _browser([t], **kw)
    ref = _browser([im], **kw)
    assert isinstance(b.ims[0], np.ndarray)
    assert b._device_image() is t
    np.testing.assert_array_equal(b.seed_view(), ref.seed_view())
    rows = ref.fit_view()
    dev_im = ref._device_image()
    assert dev_im.dtype == torch.float32 and dev_im.device.type == "cpu"
    np.testing.assert_array_equal(b.fit_view(), rows)
    ref.fit_view()
    assert ref._device_image() is dev_im


def test_browser_npz_crosses_both_ways(tmp_path):
    im, _ = _spot_stack()
    fits = np.arange(22, dtype=np.float32).reshape(2, 11)
    for k, (a, b) in enumerate(((JI.SpotBrowser, _browser),
                                (_browser, JI.SpotBrowser))):
        path = str(tmp_path / f"picks_{k}.npz")
        src = a([im, im], save_file=path)
        src.add_point(3.0, 10.0, 12.0)
        src.add_point(4.5, 20.0, 30.0, image_index=1)
        src.fits[1] = fits
        src.save()
        dst = b([im, im], save_file=path)
        np.testing.assert_array_equal(dst.points, src.points)
        np.testing.assert_array_equal(dst.point_image, src.point_image)
        assert set(dst.fits) == {1}
        np.testing.assert_array_equal(dst.fits[1], fits)
        assert dst.points.dtype == np.float64
        assert dst.point_image.dtype == np.int64


def test_marker_npz_crosses_both_ways(tmp_path):
    maps = [np.eye(30), np.ones((30, 30))]
    for k, (a, b) in enumerate(((JI.BoundaryMarker, BoundaryMarker),
                                (BoundaryMarker, JI.BoundaryMarker))):
        path = str(tmp_path / f"bounds_{k}.npz")
        src = a(maps, names=["c1", "c2"], save_file=path)
        src.add_boundary(4.2, 4.8)
        src.add_boundary(12.0, 14.0, index=1)
        dst = b(maps, names=["c1", "c2"], save_file=path)
        np.testing.assert_array_equal(dst.positions, src.positions)
        np.testing.assert_array_equal(dst.map_index, src.map_index)
        for i in (0, 1):
            np.testing.assert_array_equal(dst.domain_starts(i),
                                          src.domain_starts(i))
            for x, y in zip(dst.staircase(i), src.staircase(i)):
                np.testing.assert_array_equal(x, y)


def test_marker_state_matches_jax_through_events():
    rng = np.random.default_rng(5)
    maps = [rng.uniform(0, 900, (40, 40)) for _ in range(3)]
    got, want = BoundaryMarker(maps), JI.BoundaryMarker(maps)
    for m in (got, want):
        m.add_boundary(10.0, 14.0)
        m.on_key(type("E", (), {"key": "d"})())
        m.add_boundary(22.0, 25.0)
        m.add_boundary(30.0, 31.0)
        m.on_key(type("E", (), {"key": "shift"})())
        m.on_click(type("E", (), {"button": 3, "inaxes": m.ax,
                                  "xdata": 30.0, "ydata": 30.0})())
        m.on_key_release(type("E", (), {"key": "shift"})())
        m.on_key(type("E", (), {"key": "x"})())
        m.on_key(type("E", (), {"key": "z"})())
    np.testing.assert_array_equal(got.positions, want.positions)
    np.testing.assert_array_equal(got.map_index, want.map_index)
    assert got._clim_memory == want._clim_memory
    np.testing.assert_array_equal(got._stairs.get_xdata(),
                                  want._stairs.get_xdata())
    np.testing.assert_array_equal(got._imshow.get_array(),
                                  want._imshow.get_array())


def test_spot_browser_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    im, _ = _spot_stack()
    with pytest.raises(RuntimeError, match="CUDA"):
        SpotBrowser([im])
    assert SpotBrowser([im], device="cpu").device.type == "cpu"
