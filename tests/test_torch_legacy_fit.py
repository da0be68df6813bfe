"""PyTorch port vs JAX package: the old-generation seeding/fitting
adapters on the CPU.

Small rendered stacks (12 x 48 x 48) with noise go through both packages,
the JAX ones on their CPU paths as their own tests run them.  Seeds are
equal (the same classifier on the same stack); fitted rows are held at
the fit tolerances of tests/test_torch_fit.py (centres and widths 1e-3
px, heights and backgrounds rtol 1e-2); kept sets and counts equal.
"""

import numpy as np
import pytest
import torch

from imageanalysis3_tpu.ops import legacy_fit as jl
from imageanalysis3_tpu_torch.ops import legacy_fit as tl
from imageanalysis3_tpu_torch.synthetic import render_gaussian_spots

torch.set_num_threads(2)


def _image(seed=0, shape=(12, 48, 48), centers=None, noise=6.0):
    rng = np.random.default_rng(seed)
    if centers is None:
        centers = np.array([[6.0, 14.0, 16.0], [6.3, 30.2, 33.7],
                            [5.5, 15.0, 36.0], [6.0, 34.5, 14.2]])
    heights = rng.uniform(2000, 4000, len(centers))
    im = render_gaussian_spots(shape, centers,
                               heights, np.tile([1.6, 1.5, 1.5],
                                                (len(centers), 1)),
                               background=120.0)
    im = im + rng.normal(0, noise, shape)
    return im.astype(np.float32), np.asarray(centers)


def _rows_close(got, want):
    """The fit tolerances: centres and widths 1e-3 px, heights and
    backgrounds rtol 1e-2."""
    np.testing.assert_allclose(got[:, 1:4], want[:, 1:4], atol=1e-3)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-2)
    np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=1e-2)
    np.testing.assert_allclose(got[:, 5:8], want[:, 5:8], atol=1e-3)


@pytest.mark.parametrize("kw", [{}, {"return_h": True},
                                {"hot_pix_th": 4, "th_seed": 800.0}])
def test_get_seed_points_base_matches_jax(kw):
    im, _ = _image(1)
    got = tl.get_seed_points_base(im, device="cpu", **kw)
    want = jl.get_seed_points_base(im, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("center", [(6.0, 14.0, 16.0), None,
                                    (6.4, 14.7, 16.4)])
def test_fitsinglegaussian_fixed_width_matches_jax(center):
    im, _ = _image(2, centers=np.array([[6.0, 14.0, 16.0]]))
    kw = dict(radius=5, width_zxy=(1.6, 1.5, 1.5))
    got, ok = tl.fitsinglegaussian_fixed_width(im, center, device="cpu", **kw)
    want, wok = jl.fitsinglegaussian_fixed_width(im, center, **kw)
    assert ok == wok
    np.testing.assert_allclose(got[1:4], want[1:4], atol=1e-3)
    np.testing.assert_allclose(got[[0, 4]], want[[0, 4]], rtol=1e-2,
                               atol=1e-2)
    np.testing.assert_array_equal(got[5:], want[5:])
    none = tl.fitsinglegaussian_fixed_width(im, (100.0, 100.0, 100.0),
                                            device="cpu")
    assert none == jl.fitsinglegaussian_fixed_width(im, (100.0, 100.0,
                                                         100.0))


def test_fit_seed_points_base_matches_jax():
    close = np.array([[6.0, 20.0, 20.0], [6.0, 23.5, 20.0],
                      [6.0, 36.0, 30.0]])
    im, _ = _image(3, centers=close)
    seeds = np.round(close).T + np.array([[0], [1], [0]])
    got = tl.fit_seed_points_base(im, seeds, width_z=1.6, width_xy=1.5,
                                  device="cpu")
    want = jl.fit_seed_points_base(im, seeds, width_z=1.6, width_xy=1.5)
    assert got.shape == want.shape == (3, 8)
    _rows_close(got, want)
    assert tl.fit_seed_points_base(im, np.zeros((3, 0)),
                                   device="cpu").size == 0


@pytest.mark.parametrize("kw", [{}, {"sort_by_h": True},
                                {"remove_close_pts": False},
                                {"close_threshold": 400.0}])
def test_get_std_centers_matches_jax(kw):
    im, _ = _image(4)
    got = tl.get_STD_centers(im, th_seed=400.0, max_num_seeds=16,
                             device="cpu", **kw)
    want = jl.get_STD_centers(im, th_seed=400.0, max_num_seeds=16, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_get_std_centers_given_seeds_and_save(tmp_path):
    im, centers = _image(5)
    # 16 seeds, the planted ones and 12 far outside the stack (no pixel,
    # dropped), as many as the seeded cases' capacity: one compile of the
    # JAX fit serves both
    extra = np.stack([np.full(12, -60.0), 4.0 * np.arange(12),
                      np.full(12, 20.0)], axis=1)
    centers = np.concatenate([centers, extra])
    for seeds in (centers, centers.T):
        got = tl.get_STD_centers(im, seeds=seeds, save=True,
                                 save_folder=str(tmp_path),
                                 save_name="beads.pkl", device="cpu")
        want = jl.get_STD_centers(im, seeds=seeds)
        np.testing.assert_allclose(got, want, atol=1e-3)
        np.testing.assert_array_equal(np.load(tmp_path / "beads.npy"), got)
    assert tl.get_STD_centers(np.full((12, 48, 48), 100, np.float32),
                              max_num_seeds=16, device="cpu") is None


@pytest.mark.parametrize("min_height", [100.0, 2500.0])
def test_fit_multi_gaussian_matches_jax(min_height):
    im, centers = _image(6)
    seeds = np.concatenate([centers, [[6.0, 5.0, 40.0]]])  # one on nothing
    got = tl.fit_multi_gaussian(im, seeds, min_height=min_height,
                                device="cpu")
    want = jl.fit_multi_gaussian(im, seeds, min_height=min_height)
    assert got.shape == want.shape
    _rows_close(got, want)
    assert tl.fit_multi_gaussian(im, np.zeros((0, 3)),
                                 device="cpu").shape == (0, 11)
