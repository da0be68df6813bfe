"""PyTorch port vs JAX package: post-analysis statistics on the CPU.

``hull_distance`` runs 64 away-step Frank-Wolfe iterations in float32 in
both packages; its update is rounded once, as XLA's fused multiply-add
rounds it, so a drop step leaves the same residual weight.  Distances are
held at rtol 1e-5 / atol 1e-5 where the iteration has converged (inside
the hull, far outside), ``is_in_hull`` equal.  The bootstrap cannot draw
JAX's subsets (``jax.random.permutation``), so the test rebuilds them
from the same ``PRNGKey(seed)`` and splits and feeds them to the port's
core, ``bootstrap_probs``: hits equal except where the JAX distance lies
within 1e-4 of the cut (counted), probabilities equal up to those.  The
float64 functions (genomic scaling, spot standardisation) at rtol 1e-10,
``score_from_density`` and the density maxima exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageanalysis3_tpu.analysis import postanalysis as jp
from imageanalysis3_tpu_torch.analysis import postanalysis as tp

torch.set_num_threads(2)

F64 = dict(rtol=1e-10, atol=1e-12)


def _cloud(seed=3, n=30):
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 10, (n, 3)).astype(np.float32)
    return pts, rng.uniform(size=n) > 0.2


@pytest.mark.parametrize("q", [(0.0, 0.0, 0.0), (1.0, -2.0, 0.5),
                               (40.0, 0.0, 0.0), (0.0, 60.0, -60.0)])
def test_hull_distance_matches_jax(q):
    pts, valid = _cloud()
    q = np.asarray(q, np.float32)
    want = float(jp.hull_distance(jnp.asarray(pts), jnp.asarray(valid),
                                  jnp.asarray(q)))
    got = float(tp.hull_distance(pts, valid, q, device="cpu"))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-5)
    few = valid & (np.arange(len(valid)) < 4)
    few[np.nonzero(few)[0][-1]] = False            # 3 points: no hull
    assert float(tp.hull_distance(pts, few, q, device="cpu")) == np.inf


def test_is_in_hull_matches_jax():
    pts, _ = _cloud(4)
    queries = [np.zeros(3), np.full(3, 50.0), pts[3], np.array([2.0, 1, 0])]
    for q in queries:
        assert tp.is_in_hull(pts, q, device="cpu") == jp.is_in_hull(pts, q)
    assert not tp.is_in_hull(pts[:3], np.zeros(3), device="cpu")
    with pytest.raises(ValueError):
        tp.is_in_hull(pts, pts, device="cpu")


def _bootstrap_scene(seed=3, n_chrom=6, n_reg=40):
    rng = np.random.default_rng(seed)
    dom = np.arange(12)
    chroms = []
    for _ in range(n_chrom):
        z = rng.normal(0, 50.0, (n_reg, 3)).astype(np.float32)
        z[dom] = (rng.normal(0, 1.0, (12, 3))
                  + 30.0 * rng.standard_normal((12, 3)))
        chroms.append(z)
    spots = ([np.zeros(3, np.float32)] * 2
             + [rng.normal(0, 15, 3).astype(np.float32)
                for _ in range(n_chrom - 3)]
             + [np.full(3, np.nan, np.float32)])
    return chroms, spots, dom


def _jax_subsets(seed, n_chrom, n_iter, n_points, k):
    """JAX's draws: split PRNGKey(seed) per chromosome, each key split per
    sample, the prefix of each sample's permutation."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_chrom)
    return np.stack([np.stack([
        np.asarray(jax.random.permutation(kk, n_points))[:k]
        for kk in jax.random.split(keys[c], n_iter)])
        for c in range(n_chrom)])


@pytest.mark.parametrize("query", ["spots", "region"])
def test_bootstrap_core_on_jax_subsets_matches_jax(query):
    chroms, spots, dom = _bootstrap_scene()
    n_iter, seed, p_boot, tol = 24, 5, 0.6, 1e-3
    k = int(np.ceil(len(dom) * p_boot))
    if query == "region":       # the region's own coordinate, removed by
        spots = [c[3] for c in chroms]                  # remove_self
        want = jp.bootstrap_regions_in_domain(chroms, 3, dom,
                                              p_bootstrap=p_boot,
                                              n_iter=n_iter, seed=seed,
                                              tol=tol)
    else:
        want = jp.bootstrap_spots_in_domain(chroms, spots, dom,
                                            p_bootstrap=p_boot, n_iter=n_iter,
                                            seed=seed, tol=tol)
    subsets = _jax_subsets(seed, len(chroms), n_iter, len(dom), k)
    dm = np.stack([c[dom] for c in chroms])
    sp = np.stack(spots)
    got = tp.bootstrap_probs(dm, sp, subsets, tol, 64, device="cpu").numpy()
    # every sample's hull distance in both packages, to count near-cut hits
    base = ~np.isnan(dm).any(-1) & ~(dm == sp[:, None]).all(-1)
    clean = np.nan_to_num(dm)
    radius = np.where(base, np.linalg.norm(clean - sp[:, None], axis=-1),
                      0.0).max(1)
    cut = tol * np.maximum(radius, 1.0)
    chosen = np.zeros(subsets.shape[:2] + (len(dom),), bool)
    np.put_along_axis(chosen, subsets, True, axis=-1)
    valid = chosen & base[:, None]
    d_jax = np.asarray(jax.vmap(jax.vmap(
        lambda v, p, c: jp.hull_distance(c, v, p),
        in_axes=(0, None, None)))(jnp.asarray(valid), jnp.asarray(sp),
                                  jnp.asarray(clean)))
    d_port = tp.hull_distance(
        np.repeat(clean[:, None], n_iter, axis=1), valid,
        np.repeat(sp[:, None], n_iter, axis=1), device="cpu").numpy()
    ok = np.isfinite(sp).all(1)
    hit_j = d_jax[ok] < cut[ok, None]
    hit_p = d_port[ok] < cut[ok, None]
    near = np.abs(d_jax[ok] - cut[ok, None]) < 1e-4 * cut[ok, None]
    differ = hit_j != hit_p
    assert not (differ & ~near).any(), (d_jax[ok][differ], d_port[ok][differ])
    n_near = int(differ.sum())
    assert np.isnan(got[~ok]).all() and np.isnan(want[~ok]).all()
    np.testing.assert_allclose(got[ok], hit_p.mean(1), rtol=0, atol=1e-7)
    assert np.abs(got[ok] - want[ok]).max() <= n_near / n_iter + 1e-7
    if query == "spots":
        assert got[0] >= 0.5 and got[1] >= 0.5     # centroid spots inside


def test_bootstrap_wrapper_draws_and_regions():
    chroms, spots, dom = _bootstrap_scene(7)
    a = tp.bootstrap_spots_in_domain(chroms, spots, dom, p_bootstrap=0.6,
                                     n_iter=16, seed=2, device="cpu")
    b = tp.bootstrap_spots_in_domain(np.stack(chroms), spots, dom,
                                     p_bootstrap=0.6, n_iter=16, seed=2,
                                     device="cpu")
    assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    subs = tp.draw_bootstrap_subsets(3, 16, 12, 8, seed=2)
    assert subs.shape == (3, 16, 8)
    assert all(len(set(s.tolist())) == 8 for s in subs.reshape(-1, 8))
    regions = tp.bootstrap_regions_in_domain(chroms, 0, dom, p_bootstrap=0.6,
                                             n_iter=8, device="cpu")
    assert regions.shape == (len(chroms),) and torch.isfinite(regions).all()
    with pytest.raises(ValueError):
        tp.bootstrap_spots_in_domain(chroms, spots, dom, p_bootstrap=1.5,
                                     device="cpu")
    with pytest.raises(ValueError):
        tp.bootstrap_spots_in_domain(chroms, spots[:-1], dom, device="cpu")


@pytest.mark.parametrize("square", [False, True])
def test_region_genomic_scaling_matches_jax(square):
    rng = np.random.default_rng(8)
    z = np.cumsum(rng.normal(0, 1, (40, 3)), 0)
    z[5] = np.nan
    coords = np.linalg.norm(z[:, None] - z[None], axis=-1) if square else z
    gen = np.abs(np.arange(40)[:, None] - np.arange(40)[None]) * 1000.0
    inds = np.arange(0, 40, 2)
    got = tp.region_genomic_scaling(coords, inds, gen, device="cpu")
    want = jp.region_genomic_scaling(coords, inds, gen)
    np.testing.assert_allclose(got, want, **F64)


@pytest.mark.parametrize("pct", [50.0, 25.0, 90.0])
def test_score_from_density_matches_jax(pct):
    rng = np.random.default_rng(9)
    d1, d2 = rng.uniform(size=(2, 10, 12, 14)).astype(np.float32)
    d1[d1 < 0.3] = 0
    want = float(jp.score_from_density(jnp.asarray(d1), jnp.asarray(d2), pct))
    got = float(tp.score_from_density(d1, d2, pct, device="cpu"))
    assert got == want


def test_local_maximum_in_density_matches_jax():
    g = np.indices((16, 20, 20)).astype(np.float32)
    dens = sum(h * np.exp(-((g - np.asarray(c)[:, None, None, None]) ** 2)
                          .sum(0) / 8) for h, c in
               [(1.0, (5, 6, 7)), (0.8, (10, 14, 12)), (0.1, (3, 15, 3))])
    for win, ratio in [(5, 0.25), (3, 0.05)]:
        np.testing.assert_array_equal(
            tp.local_maximum_in_density(dens, win, ratio,
                                        device="cpu").numpy(),
            jp.local_maximum_in_density(dens, win, ratio))


@pytest.mark.parametrize("ncol,kw", [(3, {}), (4, {"scale_variance": True}),
                                     (11, {}), (11, {"center_zero": False,
                                                     "scaling": 2.0}),
                                     (11, {"pca_align": False})])
def test_normalize_center_spots_matches_jax(ncol, kw):
    rng = np.random.default_rng(10)
    spots = rng.normal(0, 5, (30, ncol)) * np.linspace(1, 3, ncol)
    spots[3, -1] = np.nan
    want, wm = jp.normalize_center_spots(spots, return_pca=True, **kw)
    got, gm = tp.normalize_center_spots(spots, return_pca=True,
                                        device="cpu", **kw)
    np.testing.assert_allclose(got.numpy(), want, **F64)
    if wm is None:
        assert gm is None
    else:
        np.testing.assert_allclose(gm.numpy(), wm, **F64)
