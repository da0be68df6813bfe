"""PyTorch port vs JAX package: the LM Gaussian fit on the CPU.

The port's LM engine runs its plain version on CPU tensors; the JAX Pallas
kernel runs in interpret mode, as tests/test_pallas.py runs it.  Fit
tolerances are those of tests/test_pallas.py:213-221.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageanalysis3_tpu import synthetic as jsyn
from imageanalysis3_tpu.ops import gaussian_fit as jg
from imageanalysis3_tpu.ops.pallas_lm import lm_fit_pallas
from imageanalysis3_tpu_torch.ops import gaussian_fit as tg
from imageanalysis3_tpu_torch.ops import lm_kernel as tl

torch.set_num_threads(2)
MIN_W, MAX_W, INIT_W = 0.5, 4.0, 1.5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hand_jacobian_matches_jacfwd(seed):
    """The hand-written 9x10 geometry Jacobian (the CUDA kernel's formulas)
    equals jax.jacfwd of gaussian_fit._scalar_geometry."""
    rng = np.random.default_rng(seed)
    n = 16
    params = rng.normal(0.0, 1.0, (n, 10)).astype(np.float32)
    center = rng.uniform(5, 50, (n, 3)).astype(np.float32)
    delta = rng.uniform(1.0, 2.5, n).astype(np.float32)

    def geom(p, c, d):
        a6, cc = jg._scalar_geometry(p, c, d, MIN_W, MAX_W)
        return jnp.concatenate([a6, cc])

    want = np.asarray(jax.vmap(jax.jacfwd(geom))(
        jnp.asarray(params), jnp.asarray(center), jnp.asarray(delta)))
    want_val = np.asarray(jax.vmap(geom)(
        jnp.asarray(params), jnp.asarray(center), jnp.asarray(delta)))
    a6, coff, ga, gc = tl.geometry_jacobian(torch.from_numpy(params),
                                            torch.from_numpy(delta),
                                            MIN_W, MAX_W)
    got = torch.cat([ga, gc], dim=1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    got_val = torch.cat([a6, coff + torch.from_numpy(center)], 1).numpy()
    np.testing.assert_allclose(got_val, want_val, rtol=1e-6, atol=1e-5)


def _scene(shape, n, seed, noise_seed, min_sep=7.0):
    rng = np.random.default_rng(seed)
    truth = jsyn.sample_spot_params(shape, n, rng, min_separation=min_sep)
    im = jsyn.render_gaussian_spots(shape, truth["centers"],
                                    truth["heights"], truth["sigmas"],
                                    truth["background"])
    im = jsyn.poisson_camera_noise(im, np.random.default_rng(noise_seed))
    return im.astype(np.float32), truth


@pytest.fixture(scope="module")
def lm_batch():
    """Round-0 inputs of N = 130 spots (not a multiple of 128), the last
    seeds invalid (all-false masks): ownership-masked blocks, the
    contested/isolated centre boxes and JAX's init params."""
    im, truth = _scene((24, 160, 160), 120, 0, 1, min_sep=8.0)
    m = min(120, len(truth["centers"]))
    seeds = np.full((130, 3), -1.0, np.float32)
    seeds[:m] = truth["centers"][:m].round()
    valid = np.arange(130) < m
    s, v = jnp.asarray(seeds), jnp.asarray(valid)
    px, co, base = jg.gather_blocks(jnp.asarray(im), s, 5)
    nidx, nmask = jg.neighbor_lists(s, v)
    own = jax.vmap(jg.ownership_mask)(co, s, s[nidx], nmask)
    mk = base & v[:, None] & own
    delta = np.where(np.asarray(jnp.any(nmask, axis=1)), 1.0,
                     2.5).astype(np.float32)
    p0 = jax.vmap(lambda a, b, c, d, e: jg.init_params(
        a, b, MIN_W, MAX_W, INIT_W, coords=c, center_est=d, delta=e))(
        px, mk, co, s, jnp.asarray(delta))
    arrays = [np.array(a) for a in (px, co, mk)] + [seeds, delta,
                                                    np.array(p0)]
    return im, arrays, valid


def _natural(params, eps, seeds, delta):
    return np.asarray(jax.vmap(lambda p, c, d, e: jg.to_natural(
        p, c, d, MIN_W, MAX_W, e))(jnp.asarray(params), jnp.asarray(seeds),
                                   jnp.asarray(delta), jnp.asarray(eps)))


def _assert_fits_close(nat_t, nat_j, ok):
    np.testing.assert_allclose(nat_t[ok, 1:4], nat_j[ok, 1:4], atol=1e-3)
    np.testing.assert_allclose(nat_t[ok, 0], nat_j[ok, 0], rtol=1e-2)
    np.testing.assert_allclose(nat_t[ok, 5:8], nat_j[ok, 5:8], atol=1e-3)


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla"])
def test_lm_fit_plain_matches_jax(lm_batch, reference):
    _, (px, co, mk, seeds, delta, p0), valid = lm_batch
    if reference == "pallas_interpret":
        pj, ej = lm_fit_pallas(jnp.asarray(px), jnp.asarray(co),
                               jnp.asarray(mk), jnp.asarray(seeds),
                               jnp.asarray(delta), jnp.asarray(p0),
                               MIN_W, MAX_W, lm_iters=8, interpret=True)
    else:
        pj, ej = jg._batched_lm(jnp.asarray(px), jnp.asarray(co),
                                jnp.asarray(mk), jnp.asarray(seeds),
                                jnp.asarray(delta), MIN_W, MAX_W, INIT_W, 8,
                                jnp.asarray(p0), True, "xla")
    pt, et = tl.lm_fit_plain(*(torch.from_numpy(a) for a in
                               (px, co, mk, seeds, delta, p0)),
                             MIN_W, MAX_W, lm_iters=8)
    assert torch.isfinite(pt).all() and torch.isfinite(et).all()
    nat_j = _natural(pj, ej, seeds, delta)
    nat_t = _natural(pt.numpy(), et.numpy(), seeds, delta)
    ok = valid & np.isfinite(nat_j).all(1) & (mk.sum(1) > 10)
    assert ok.sum() >= 100
    _assert_fits_close(nat_t, nat_j, ok)
    np.testing.assert_allclose(et.numpy()[ok], np.asarray(ej)[ok],
                               rtol=1e-3)


def test_lm_fit_dispatches_cpu_to_plain(lm_batch):
    im, (px, co, mk, seeds, delta, p0), _ = lm_batch
    args = [torch.from_numpy(a) for a in (px, co, mk, seeds, delta, p0)]
    tl.launches = 0
    a = tl.lm_fit(*args, MIN_W, MAX_W, lm_iters=3)
    b = tl.lm_fit_plain(*args, MIN_W, MAX_W, lm_iters=3)
    assert tl.launches == 0
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        tl.lm_fit_cuda(*args, MIN_W, MAX_W)


def test_init_params_and_blocks_match_jax(lm_batch):
    im, (px, co, mk, seeds, delta, p0), _ = lm_batch
    t_seeds = torch.from_numpy(seeds)
    tpx, tco, tmk = tg.gather_blocks(torch.from_numpy(im), t_seeds, 5)
    np.testing.assert_array_equal(tco.numpy(), co)
    t_valid = t_seeds[:, 0] >= 0
    nidx, nmask = tg.neighbor_lists(t_seeds, t_valid)
    tmk = (tmk & t_valid[:, None]
           & tg.ownership_mask(tco, t_seeds, t_seeds[nidx], nmask))
    np.testing.assert_array_equal(tmk.numpy(), mk)
    np.testing.assert_array_equal(tpx.numpy()[mk], px[mk])
    tp0 = tg.init_params(tpx, tmk, MIN_W, MAX_W, INIT_W, coords=tco,
                         center_est=torch.from_numpy(seeds),
                         delta=torch.from_numpy(delta))
    # bk, h, widths: same arithmetic
    keep = [0, 1, 5, 6, 7, 8, 9]
    np.testing.assert_allclose(tp0.numpy()[:, keep], p0[:, keep], rtol=1e-5,
                               atol=1e-5)
    # centroid start: 512-term f32 sums of coords (up to 160 px) times
    # weights (up to ~3000) in another order (~1e-5 px), amplified by the
    # atanh box transform
    np.testing.assert_allclose(tp0.numpy()[:, 2:5], p0[:, 2:5], atol=5e-4)


def test_neighbors_and_ownership_match_jax():
    rng = np.random.default_rng(3)
    seeds = rng.integers(0, 30, (40, 3)).astype(np.float32)
    valid = rng.uniform(size=40) > 0.2
    ij, mj = jg.neighbor_lists(jnp.asarray(seeds), jnp.asarray(valid))
    it, mt = tg.neighbor_lists(torch.from_numpy(seeds),
                               torch.from_numpy(valid))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    # neighbour sets per seed (top-k tie order may differ)
    for a, b, m in zip(it.numpy(), np.asarray(ij), np.asarray(mj)):
        assert sorted(a[m]) == sorted(b[m])
    coords = rng.uniform(0, 30, (40, 50, 3)).astype(np.float32)
    own_j = jax.vmap(jg.ownership_mask)(jnp.asarray(coords),
                                        jnp.asarray(seeds),
                                        jnp.asarray(seeds)[ij], mj)
    own_t = tg.ownership_mask(torch.from_numpy(coords),
                              torch.from_numpy(seeds),
                              torch.from_numpy(seeds)[it], mt)
    np.testing.assert_array_equal(own_t.numpy(), np.asarray(own_j))


def test_iter_fit_seed_points_matches_jax():
    """Round 0 + Jacobi rounds, port (plain LM) vs JAX (XLA engine), with
    the tolerances of tests/test_pallas.py:213-221."""
    im, truth = _scene((24, 96, 128), 24, 0, 3)
    seeds = truth["centers"].round().astype(np.float32)
    valid = np.ones(len(seeds), bool)
    valid[-2] = False
    r_j = jg.iter_fit_seed_points(jnp.asarray(im), jnp.asarray(seeds),
                                  jnp.asarray(valid), lm_iters=8,
                                  n_max_iter=3, lm_backend="xla")
    r_t = tg.iter_fit_seed_points(torch.from_numpy(im),
                                  torch.from_numpy(seeds),
                                  torch.from_numpy(valid), lm_iters=8,
                                  n_max_iter=3)
    vj = np.asarray(r_j.valid)
    np.testing.assert_array_equal(r_t.valid.numpy(), vj)
    assert int(r_t.n_contested) == int(r_j.n_contested)
    assert int(r_t.n_rounds) == int(r_j.n_rounds)
    _assert_fits_close(r_t.spots.numpy(), np.asarray(r_j.spots), vj)
