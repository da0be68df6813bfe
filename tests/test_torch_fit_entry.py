"""PyTorch port vs JAX package: the fit's other entry points on the CPU.

``find_image_background``, ``fit_fov_image``, ``get_centers`` /
``_dedupe_mask``, ``select_sparse_centers`` and the batched ``gfit_fast``.
The port's kernels run their plain versions on CPU tensors; the JAX side
takes its CPU paths (the XLA LM engine).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageanalysis3_tpu import synthetic as jsyn
from imageanalysis3_tpu.ops import gaussian_fit as jg
from imageanalysis3_tpu_torch.ops import gaussian_fit as tg

torch.set_num_threads(2)


def _scene(shape=(10, 96, 96), n=10, seed=4, min_sep=12.0):
    """tests/test_profiles.py's background scene: isolated spots (12 px
    apart, so no Jacobi refit) with shot and read noise."""
    rng = np.random.default_rng(seed)
    truth = jsyn.sample_spot_params(shape, n, rng, min_separation=min_sep,
                                    background=150.0)
    im = jsyn.render_gaussian_spots(shape, truth["centers"],
                                    truth["heights"], truth["sigmas"],
                                    truth["background"])
    return jsyn.poisson_camera_noise(im, rng).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.mark.parametrize("case", ["peak", "no_peak"])
def test_find_image_background_matches_jax(scene, case):
    """Exact: the same histogram and the same first maximum; without an
    interior peak (every voxel in the last bin) both fall back to the
    counting median."""
    im = scene if case == "peak" else np.full((4, 16, 16), 65535.0,
                                              np.float32)
    got = float(tg.find_image_background(torch.from_numpy(im)))
    want = float(jg.find_image_background(jnp.asarray(im)))
    assert got == want
    if case == "peak":
        assert 120.0 <= got <= 180.0


def _assert_fits_close(a, b, ok):
    """test_torch_fit.py's tolerances: isolated spots within 1e-3 px, heights
    within rtol 1e-2, widths within 1e-3."""
    np.testing.assert_allclose(a[ok, 1:4], b[ok, 1:4], atol=1e-3)
    np.testing.assert_allclose(a[ok, 0], b[ok, 0], rtol=1e-2)
    np.testing.assert_allclose(a[ok, 5:8], b[ok, 5:8], atol=1e-3)


@pytest.mark.parametrize("normalize", [False, True])
def test_fit_fov_image_matches_jax(scene, normalize):
    kw = dict(th_seed=300.0, max_num_seeds=32,
              normalize_background=normalize)
    rj = jg.fit_fov_image(jnp.asarray(scene), **kw)
    rt = tg.fit_fov_image(scene, device="cpu", **kw)
    vj = np.asarray(rj.valid)
    assert vj.sum() >= 8
    np.testing.assert_array_equal(rt.valid.numpy(), vj)
    _assert_fits_close(rt.spots.numpy(), np.asarray(rj.spots), vj)


def test_fit_fov_image_forwards_seed_kwargs(scene):
    """`seed_kwargs` reach get_seeds as in the JAX package."""
    kw = dict(th_seed=300.0, max_num_seeds=32, min_edge_distance=4,
              dynamic_niters=5, lm_iters=8, n_max_iter=2)
    rj = jg.fit_fov_image(jnp.asarray(scene), **kw)
    rt = tg.fit_fov_image(torch.from_numpy(scene), **kw)
    vj = np.asarray(rj.valid)
    np.testing.assert_array_equal(rt.valid.numpy(), vj)
    _assert_fits_close(rt.spots.numpy(), np.asarray(rj.spots), vj)


def test_entry_points_need_a_device_for_numpy(scene):
    """NumPy input goes to the card by default, which this machine lacks."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tg.fit_fov_image(scene)


def test_get_centers_matches_jax(scene):
    cj, vj = jg.get_centers(jnp.asarray(scene), th_seed=300.0,
                            max_num_seeds=32)
    ct, vt = tg.get_centers(scene, th_seed=300.0, max_num_seeds=32,
                            device="cpu")
    vj = np.asarray(vj)
    np.testing.assert_array_equal(vt.numpy(), vj)
    np.testing.assert_allclose(ct.numpy()[vj], np.asarray(cj)[vj], atol=1e-3)


def test_dedupe_mask_matches_jax():
    """Exact: the first of each group of centres closer than the threshold
    survives; invalid centres neither survive nor suppress."""
    rng = np.random.default_rng(0)
    c = rng.uniform(0, 50, (60, 3)).astype(np.float32)
    c[10:20] = c[:10] + rng.uniform(-0.05, 0.05, (10, 3)).astype(np.float32)
    c[20:25] = c[:5]
    valid = rng.uniform(size=60) > 0.15
    want = np.asarray(jg._dedupe_mask(jnp.asarray(c), jnp.asarray(valid),
                                      0.1))
    got = tg._dedupe_mask(torch.from_numpy(c), torch.from_numpy(valid), 0.1)
    assert (~want & valid).sum() >= 5
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_select_sparse_centers_matches_jax(seed):
    """Exact: the greedy first-come walk over 200 crowded centres."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 120, (200, 3)).astype(np.float32)
    valid = rng.uniform(size=200) > 0.2
    want = np.asarray(jg.select_sparse_centers(jnp.asarray(c),
                                               jnp.asarray(valid), 25.0))
    got = tg.select_sparse_centers(torch.from_numpy(c),
                                   torch.from_numpy(valid), 25.0)
    assert 5 <= want.sum() < valid.sum()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("reconstruct", [False, True])
def test_gfit_fast_batched_matches_jax(scene, reconstruct):
    """One batched call against jax.vmap(gfit_fast) over 40 blocks (some
    near the edges, partly masked): rtol 1e-5, with an absolute floor of
    1e-5 of each column's largest magnitude for entries near zero (the
    off-diagonal covariances), where 1000-term f32 sums in another order
    differ in the last bits."""
    rng = np.random.default_rng(2)
    seeds = rng.uniform(0, [10, 96, 96], (40, 3)).astype(np.float32)
    px, co, mk = jg.gather_blocks(jnp.asarray(scene), jnp.asarray(seeds), 5)
    want = np.asarray(jax.vmap(lambda p, c, m: jg.gfit_fast(
        p, c, m, reconstruct=reconstruct))(px, co, mk))
    got = tg.gfit_fast(torch.from_numpy(np.array(px)),
                       torch.from_numpy(np.array(co)),
                       torch.from_numpy(np.array(mk)),
                       reconstruct=reconstruct).numpy()
    assert got.shape == (40, 12)
    if not reconstruct:
        assert np.isnan(got[:, 11]).all() and np.isnan(want[:, 11]).all()
        got, want = got[:, :11], want[:, :11]
    floor = 1e-5 * np.abs(want).max(axis=0, keepdims=True)
    assert (np.abs(got - want) <= 1e-5 * np.abs(want) + floor).all()
