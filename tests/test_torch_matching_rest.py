"""PyTorch port vs JAX package: the rest of ops/matching.py on the CPU.

Rigid transforms (float64) at rtol 1e-10; spot translation and the
cumulative drifts (float32) at rtol 1e-5 / atol 1e-5; matched spot
selection and recombination equal.  ``fit_matched_centers`` seeds, fits
and pairs a small rendered stack (12 x 64 x 64) in both packages, the
JAX one on its CPU path as its own tests run it: the same pairs, the
matched centres at the fit tolerances of tests/test_torch_fit.py (1e-3
px) and the drift at 1e-3 px.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageanalysis3_tpu.ops import matching as jm
from imageanalysis3_tpu_torch.ops import matching as tm
from imageanalysis3_tpu_torch.synthetic import render_gaussian_spots

torch.set_num_threads(2)

F64 = dict(rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("dim", [2, 3])
def test_rigid_transform_matches_jax(dim):
    rng = np.random.default_rng(dim)
    before = rng.uniform(0, 1000, (8, dim))
    ang = 0.3
    rot = np.eye(dim)
    rot[:2, :2] = [[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]]
    after = before @ rot + rng.uniform(-50, 50, dim) \
        + rng.normal(0, 0.5, before.shape)
    r, t = tm.rigid_transform_from_points(before, after, device="cpu")
    wr, wt = jm.rigid_transform_from_points(before, after)
    np.testing.assert_allclose(r.numpy(), wr, **F64)
    np.testing.assert_allclose(t.numpy(), wt, rtol=1e-10, atol=1e-9)


def test_align_manual_points_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    before = rng.uniform(0, 500, (5, 2))
    after = before[:, ::-1] * [1, -1] + 20.0
    a, b = tmp_path / "before.txt", tmp_path / "after.txt"
    np.savetxt(a, before, delimiter=",")
    np.savetxt(b, after, delimiter=",")
    r, t = tm.align_manual_points(str(a), str(b), device="cpu")
    wr, wt = jm.align_manual_points(str(a), str(b))
    np.testing.assert_allclose(r.numpy(), wr, **F64)
    np.testing.assert_allclose(t.numpy(), wt, rtol=1e-10, atol=1e-9)


@pytest.mark.parametrize("with_drift", [False, True])
def test_translate_spot_coordinates_matches_jax(with_drift):
    rng = np.random.default_rng(6)
    spots = rng.uniform(0, 2048, (20, 11)).astype(np.float32)
    c, s = np.cos(0.2), np.sin(0.2)
    rot = np.array([[c, -s], [s, c]], np.float32)
    centre = np.array([1024.0, 1024.0], np.float32)
    drift = np.array([0.5, -3.0, 7.25], np.float32) if with_drift else None
    got = tm.translate_spot_coordinates(spots, rot, centre, drift,
                                        device="cpu").numpy()
    want = np.asarray(jm.translate_spot_coordinates(
        jnp.asarray(spots), jnp.asarray(rot), jnp.asarray(centre),
        None if drift is None else jnp.asarray(drift)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_select_matched_spots_matches_jax():
    rng = np.random.default_rng(7)
    cand = rng.uniform(0, 20, (12, 11)).astype(np.float32)
    cand[:, 0] = rng.uniform(100, 1000, 12)
    for ref, th in [(cand[3, 1:4] + 0.1, 300.0), (cand[3, 1:4], 5000.0),
                    (np.full(3, 500.0), 100.0)]:
        row, found = tm.select_matched_spots(cand, ref, th, device="cpu")
        wrow, wfound = jm.select_matched_spots(cand, ref, th)
        assert found == wfound
        np.testing.assert_array_equal(row.numpy(), wrow)
    row, found = tm.select_matched_spots(np.zeros((0, 11)), np.zeros(3),
                                         10.0, device="cpu")
    assert not found and torch.isnan(row).all()


def test_generate_recombined_spots_matches_jax():
    orig = [np.full((2, 11), k) for k in range(4)]
    rep = [np.full((3, 11), 10 + k) for k in range(2)]
    got = tm.generate_recombined_spots(rep, [2, 0], orig, [5, 6, 0, 2])
    want = jm.generate_recombined_spots(rep, [2, 0], orig, [5, 6, 0, 2])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        tm.generate_recombined_spots(rep, [9, 0], orig, [5, 6, 0, 2])
    with pytest.raises(IndexError):
        tm.generate_recombined_spots(rep, [2], orig, [5, 6, 0, 2])


def test_accumulate_sequential_drifts_matches_jax():
    steps = np.random.default_rng(8).normal(0, 2, (9, 3)).astype(np.float32)
    got = tm.accumulate_sequential_drifts(steps, device="cpu").numpy()
    want = np.asarray(jm.accumulate_sequential_drifts(jnp.asarray(steps)))
    assert got.shape == (10, 3) and not got[0].any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _anchor_image(seed=9, n=14, shape=(12, 64, 64)):
    rng = np.random.default_rng(seed)
    pts = []
    while len(pts) < n:
        p = rng.uniform([3, 6, 6], [shape[0] - 3, shape[1] - 6,
                                    shape[2] - 6])
        if all(np.linalg.norm(p - q) > 9 for q in pts):
            pts.append(p)
    pts = np.asarray(pts)
    im = render_gaussian_spots(shape, pts, rng.uniform(2000, 4000, n),
                               np.tile([1.6, 1.5, 1.5], (n, 1)),
                               background=150.0)
    im = im + rng.normal(0, 8, shape).astype(np.float32)
    return im.astype(np.float32), pts


def test_fit_matched_centers_matches_jax():
    im, pts = _anchor_image()
    anchors = pts[:10] + [0.0, 0.7, -0.4]          # moved within the cutoff
    got = tm.fit_matched_centers(im, anchors, match_distance_th=2.0,
                                 th_seed=500.0, max_num_seeds=32,
                                 device="cpu")
    want = jm.fit_matched_centers(im, anchors, match_distance_th=2.0,
                                  th_seed=500.0, max_num_seeds=32)
    mask = got.mask.numpy()
    np.testing.assert_array_equal(mask, np.asarray(want.mask))
    assert int(got.n_pairs) == int(want.n_pairs) >= 9
    np.testing.assert_array_equal(got.ref.numpy()[mask],
                                  np.asarray(want.ref)[mask])
    np.testing.assert_allclose(got.tar.numpy()[mask],
                               np.asarray(want.tar)[mask], atol=1e-3)
    np.testing.assert_allclose(got.drift.numpy(), np.asarray(want.drift),
                               atol=1e-3)
