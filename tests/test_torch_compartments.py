"""PyTorch port vs JAX package: compartment analysis on the CPU.

The float32 functions (``normalize_center_spots``, ``ab_axis_projection``,
``spots_to_density``, ``compartment_scores``) are held at rtol 1e-5 /
atol 1e-5 against the JAX functions on seeded clouds with missing spots;
PCA-rotated coordinates up to a sign per axis (an eigenvector's sign is
free).  A density is a rank-N product of each spot's three axis factors
here and an (N, G^3) sum of exp(a + b + c) in the JAX package: they differ
in the last bits, and the JAX package's float32 grid sum is itself off
from 1 by ~5e-5 at G = 16, which the atol covers.  Each slice of a batch
equals the unbatched result.  ``ab_compartment_eigenscore`` (float64) is
held at rtol 1e-10 with its orientation; ``winsorize``,
``randomize_index_dict`` (the same NumPy generator draws the same groups)
and ``density_overlaps`` exactly or at rtol 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageanalysis3_tpu.analysis import compartments as jc
from imageanalysis3_tpu_torch.analysis import compartments as tc

torch.set_num_threads(2)

F32 = dict(rtol=1e-5, atol=1e-5)


def _cloud(seed=0, n=48, missing=0.15):
    """Two offset blobs (A, B) of spots with missing rows."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=n) < 0.5
    z = rng.normal(0, 2.0, (n, 3)) + np.where(a[:, None], 1.5, -1.5)
    z = z * np.array([1.0, 1.5, 0.7])
    valid = rng.uniform(size=n) >= missing
    z[~valid] = np.nan
    return z.astype(np.float32), valid, a, ~a


def _up_to_sign(got, want):
    s = np.sign(np.nansum(got * want, axis=-2, keepdims=True))
    np.testing.assert_allclose(got * s, want, **F32)


@pytest.mark.parametrize("pca", [False, True])
def test_normalize_center_spots_matches_jax(pca):
    z, v, _, _ = _cloud(1)
    want = np.asarray(jc.normalize_center_spots(jnp.asarray(z),
                                                jnp.asarray(v), pca, 1.7))
    got = tc.normalize_center_spots(z, v, pca, 1.7, device="cpu").numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    _up_to_sign(got, want)


def test_normalize_center_spots_batched_slices():
    clouds = [_cloud(s) for s in range(3)]
    z = np.stack([c[0] for c in clouds])
    v = np.stack([c[1] for c in clouds])
    batch = tc.normalize_center_spots(z, v, True, device="cpu").numpy()
    for k in range(3):
        one = tc.normalize_center_spots(z[k], v[k], True, device="cpu")
        np.testing.assert_allclose(batch[k], one.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_ab_axis_projection_matches_jax():
    z, v, a, b = _cloud(2)
    want = np.asarray(jc.ab_axis_projection(*map(jnp.asarray, (z, v, a, b))))
    got = tc.ab_axis_projection(z, v, a, b, device="cpu").numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    # the A-B axis is fixed; the PCA'd tail two axes are free in sign
    np.testing.assert_allclose(got[:, 0], want[:, 0], **F32)
    _up_to_sign(got[:, 1:], want[:, 1:])


@pytest.mark.parametrize("grid_radius,sigma,voxel", [(8, 2.0, 1.0),
                                                     (6, 1.5, 0.8)])
def test_spots_to_density_matches_jax(grid_radius, sigma, voxel):
    z, v, _, _ = _cloud(3)
    want = np.asarray(jc.spots_to_density(jnp.asarray(z), jnp.asarray(v),
                                          grid_radius, sigma, voxel))
    got = tc.spots_to_density(z, v, grid_radius, sigma, voxel,
                              device="cpu").numpy()
    assert got.shape == want.shape == (2 * grid_radius,) * 3
    np.testing.assert_allclose(got, want, **F32)
    assert abs(got.sum() - 1.0) < 1e-5


def test_compartment_scores_match_jax_and_batch():
    clouds = [_cloud(s) for s in (4, 5)]
    want = [np.asarray(jc.compartment_scores(*map(jnp.asarray, c),
                                             grid_radius=8)) for c in clouds]
    batch = tc.compartment_scores(*(np.stack([c[k] for c in clouds])
                                    for k in range(4)), grid_radius=8,
                                  device="cpu").numpy()
    for k, w in enumerate(want):
        assert np.array_equal(np.isnan(batch[k]), np.isnan(w))
        np.testing.assert_allclose(batch[k], w, **F32)
        # A spots score A-like on average
        _, v, a, _ = clouds[k]
        assert np.nanmean(batch[k][a & v]) > np.nanmean(batch[k][~a & v])


def _checkerboard_map(seed, r=50, missing=(7, 31)):
    rng = np.random.default_rng(seed)
    lab = (np.arange(r) // 5) % 2
    base = np.abs(np.arange(r)[:, None] - np.arange(r)[None]) ** 0.4 * 200
    dm = base * np.where(lab[:, None] == lab[None], 0.7, 1.3)
    dm = dm * rng.uniform(0.9, 1.1, (r, r))
    dm = (dm + dm.T) / 2
    np.fill_diagonal(dm, 0.0)
    dm[list(missing)] = np.nan
    dm[:, list(missing)] = np.nan
    return dm, lab


@pytest.mark.parametrize("explicit_valid", [False, True])
def test_ab_compartment_eigenscore_matches_jax(explicit_valid):
    missing = (7, 31) if explicit_valid else ()
    dm, lab = _checkerboard_map(6, missing=missing)
    valid = np.ones(len(dm), bool)
    valid[list(missing)] = False
    kw = {"valid": valid} if explicit_valid else {}
    want = jc.ab_compartment_eigenscore(dm, **kw)
    got = tc.ab_compartment_eigenscore(dm, device="cpu", **kw).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    agree = np.mean((got[valid] > 0) == (lab[valid] == lab[valid][0]))
    assert max(agree, 1 - agree) >= 0.9


@pytest.mark.parametrize("normalize", [False, True])
def test_winsorize_matches_jax(normalize):
    s = np.random.default_rng(7).normal(size=80)
    s[[3, 40]] = np.nan
    np.testing.assert_array_equal(
        tc.winsorize(s, 10.0, 5.0, normalize),
        jc.winsorize(s, 10.0, 5.0, normalize))


def test_randomize_index_dict_same_rng_same_groups():
    d = {"A": np.arange(0, 30, 2), "B": np.arange(1, 20, 2)}
    got = tc.randomize_index_dict(d, rng=np.random.default_rng(3))
    want = jc.randomize_index_dict(d, rng=np.random.default_rng(3))
    for k in ("A", "B"):
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(KeyError):
        tc.randomize_index_dict({"A": [1]})


def test_density_overlaps_matches_jax():
    rng = np.random.default_rng(8)
    d1, d2 = rng.uniform(size=(2, 10, 10, 10))
    d1[0, 0, 0] = np.nan
    assert tc.density_overlaps(d1, d2, device="cpu") == pytest.approx(
        jc.density_overlaps(d1, d2), rel=1e-10)
    with pytest.raises(ValueError):
        tc.density_overlaps(d1, d2, method="other", device="cpu")
