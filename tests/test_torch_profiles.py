"""PyTorch port vs JAX package: correction-profile generation on the CPU.

Quantiles, the illumination profiler, the per-spot pair regressions, the
polynomial field and chromatic fits (SVD least squares, rank-deficient case
included), the mixing inverse, centre pairing and its check, the three
generation workflows on tests/test_profiles.py's scenes, and the profile
files both ways between the packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageanalysis3_tpu import synthetic as jsyn
from imageanalysis3_tpu.io import profiles_io as jio
from imageanalysis3_tpu.ops import gaussian_fit as jg
from imageanalysis3_tpu.ops import matching as jm
from imageanalysis3_tpu.ops import profiles as jp
from imageanalysis3_tpu.ops import warp as jw
from imageanalysis3_tpu_torch import synthetic as tsyn
from imageanalysis3_tpu_torch.io import profiles_io as tio
from imageanalysis3_tpu_torch.ops import gaussian_fit as tg
from imageanalysis3_tpu_torch.ops import matching as tm
from imageanalysis3_tpu_torch.ops import profiles as tp
from imageanalysis3_tpu_torch.ops import warp as tw

torch.set_num_threads(2)
T = torch.from_numpy


@pytest.mark.parametrize("q", [0.05, 0.5, 0.9])
def test_counting_quantile_matches_jax(q):
    """Exact: the same f32 rank and the same binary search."""
    x = np.random.default_rng(0).integers(0, 2000, (7, 50, 50)) \
        .astype(np.float32) + 0.25
    assert float(tp.counting_quantile(T(x), q)) \
        == float(jp.counting_quantile(jnp.asarray(x), q))


@pytest.mark.parametrize("q", [0.05, 0.9, 0.123456, 0.987654321])
def test_quantile_rank_is_jax_f32_rank(q):
    """At a full stack's n = 60 * 2048 * 2048 the rank is JAX's: the Python
    product rounded to f32, then ceil (f32 spacing 16 there)."""
    n = 60 * 2048 * 2048
    want = int(jnp.maximum(1, jnp.ceil(q * n).astype(jnp.int32)))
    assert tp._quantile_rank(q, n) == want


def test_illumination_profile_matches_jax():
    """tests/test_profiles.py's vignette scene through both profilers:
    within 1e-5 of the profile's maximum (1), the spread of two f32 481-tap
    band products summed in another order."""
    rng = np.random.default_rng(1)
    shape = (8, 128, 128)
    prof_true = jsyn.illumination_profile(shape[1:], falloff=0.4)
    pj = jp.IlluminationProfiler(shape[1:], smooth_sigma=12.0)
    pt = tp.IlluminationProfiler(shape[1:], smooth_sigma=12.0, device="cpu")
    for _ in range(4):
        im, _ = jsyn.random_spot_field(shape, 6, rng,
                                       height_range=(500.0, 1500.0),
                                       background=400.0)
        raw = np.round(jsyn.poisson_camera_noise(im * prof_true[None], rng))
        pj.add_stack(raw.astype(np.float32))
        pt.add_stack(raw.astype(np.uint16))        # camera counts
    want, got = pj.finalize(), pt.finalize()
    assert isinstance(got, np.ndarray)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _bleed_scene():
    """tests/test_profiles.py's two-channel bleed scene."""
    rng = np.random.default_rng(2)
    shape = (10, 96, 96)
    im0, _ = jsyn.random_spot_field(shape, 10, rng, min_separation=14.0,
                                    height_range=(2000.0, 4000.0),
                                    background=0.0)
    im1, _ = jsyn.random_spot_field(shape, 10, rng, min_separation=14.0,
                                    height_range=(2000.0, 4000.0),
                                    background=0.0)
    mix = np.array([[1.0, 0.12], [0.08, 1.0]], np.float32)
    return (np.einsum("ij,jzxy->izxy", mix, np.stack([im0, im1]))
            + 100.0).astype(np.float32)


def test_fit_spot_pair_regressions_matches_jax():
    """Slopes, intercepts and r^2 within rtol 1e-5 (254-term f32 sums in
    another order) on the rows whose fitted centre is finite; validity
    equal."""
    obs = _bleed_scene()
    res = jg.fit_fov_image(jnp.asarray(obs[0]), max_num_seeds=64,
                           th_seed=500.0)
    centers, valid = np.array(res.spots[:, 1:4]), np.array(res.valid)
    rj = jp.fit_spot_pair_regressions(jnp.asarray(obs[0]),
                                      jnp.asarray(obs[1]),
                                      jnp.asarray(centers),
                                      jnp.asarray(valid), 4)
    rt = tp.fit_spot_pair_regressions(T(obs[0]), T(obs[1]), T(centers),
                                      T(valid), 4)
    fin = np.isfinite(centers).all(1)
    assert valid.sum() >= 8
    np.testing.assert_array_equal(rt.valid.numpy()[fin],
                                  np.asarray(rj.valid)[fin])
    for a, b in zip(rt[:3], rj[:3]):
        np.testing.assert_allclose(a.numpy()[fin], np.asarray(b)[fin],
                                   rtol=1e-5, atol=1e-6)


def test_polynomial_field_matches_jax():
    """The weighted order-2 slope field over a 96x80 grid: rtol 1e-4 of the
    field's scale (a 6-column normalised SVD solve, then 7680 basis rows)."""
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, [96, 80], (40, 2)).astype(np.float32)
    vals = (0.08 + 1e-4 * xy[:, 0] - 2e-4 * xy[:, 1]
            + rng.normal(0, 1e-3, 40)).astype(np.float32)
    w = (rng.uniform(size=40) > 0.3).astype(np.float32)
    want = np.asarray(jp.polynomial_field_2d(jnp.asarray(xy),
                                             jnp.asarray(vals),
                                             jnp.asarray(w), (96, 80)))
    got = tp.polynomial_field_2d(T(xy), T(vals), T(w), (96, 80)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_polynomial_field_ignores_dropped_nonfinite_rows():
    """A weight-0 row whose centre or value is NaN does not reach the solve:
    the field equals the one without that row."""
    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 64, (30, 2)).astype(np.float32)
    vals = rng.uniform(0.05, 0.1, 30).astype(np.float32)
    w = np.ones(30, np.float32)
    xy_bad, vals_bad, w_bad = (np.vstack([xy, [[np.nan, 3.0]]]),
                               np.append(vals, np.nan), np.append(w, 0.0))
    a = tp.polynomial_field_2d(T(xy_bad.astype(np.float32)),
                               T(vals_bad.astype(np.float32)),
                               T(w_bad.astype(np.float32)), (64, 64))
    b = tp.polynomial_field_2d(T(xy), T(vals), T(w), (64, 64))
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_pairs", [40, 6], ids=["full_rank", "6_pairs"])
def test_fit_chromatic_constants_matches_jax(n_pairs):
    """rtol 1e-4 of each row's scale.  With 6 pairs for 10 monomials the
    system is rank-deficient and both take the minimum-norm solution of the
    SVD solve with JAX's cut-off (a QR solve would not)."""
    rng = np.random.default_rng(5)
    ref = rng.uniform([2, 10, 10], [22, 500, 500], (n_pairs, 3)) \
        .astype(np.float32)
    tar = (ref + rng.normal(0, 0.5, ref.shape)).astype(np.float32)
    center = np.array([12.0, 256.0, 256.0], np.float32)
    want = np.asarray(jw.fit_chromatic_constants(
        jnp.asarray(tar), jnp.asarray(ref), jnp.asarray(center)))
    got = tw.fit_chromatic_constants(T(tar), T(ref), T(center)).numpy()
    assert got.shape == (3, 10)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    # both reproduce the pairs' shifts in the rank-deficient case
    if n_pairs < 10:
        fit = tw.evaluate_poly_shifts(T(ref), T(got), 2, T(center))
        np.testing.assert_allclose(fit.numpy(), tar - ref, atol=1e-3)


def test_invert_mixing_profile_matches_jax():
    """rtol 1e-5: per-pixel 3x3 inverses of near-identity mixings."""
    rng = np.random.default_rng(6)
    mix = np.eye(3, dtype=np.float32)[:, :, None, None] \
        + rng.uniform(0, 0.15, (3, 3, 20, 24)).astype(np.float32)
    want = np.asarray(jp.invert_mixing_profile(jnp.asarray(mix)))
    got = tp.invert_mixing_profile(T(mix)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _pair_tables(seed):
    """Crowded tables: 60 ref centres, tar = shifted ref with jitter and 6
    outlier shifts, invalid rows and distractors."""
    rng = np.random.default_rng(seed)
    ref = rng.uniform(0, 60, (60, 3)).astype(np.float32)
    tar = ref - np.array([0.5, -0.3, 0.8], np.float32) \
        + rng.normal(0, 0.1, ref.shape).astype(np.float32)
    tar[:6] += rng.uniform(1.0, 1.4, (6, 3)).astype(np.float32)
    perm = rng.permutation(60)
    return (tar, rng.uniform(size=60) > 0.1, ref[perm],
            rng.uniform(size=60) > 0.1)


@pytest.mark.parametrize("seed", [0, 1])
def test_pairing_and_check_match_jax(seed):
    """Masks and counts exact; drifts within 1e-5."""
    tar, tv, ref, rv = _pair_tables(seed)
    drift = np.array([0.4, -0.2, 0.7], np.float32)
    pj = jm.find_paired_centers(jnp.asarray(tar), jnp.asarray(tv),
                                jnp.asarray(ref), jnp.asarray(rv),
                                jnp.asarray(drift), cutoff=2.0)
    pt = tm.find_paired_centers(T(tar), T(tv), T(ref), T(rv), T(drift),
                                cutoff=2.0)
    np.testing.assert_array_equal(pt.mask.numpy(), np.asarray(pj.mask))
    assert int(pt.n_pairs) == int(pj.n_pairs) >= 20
    np.testing.assert_array_equal(pt.ref.numpy()[pt.mask.numpy()],
                                  np.asarray(pj.ref)[np.asarray(pj.mask)])
    np.testing.assert_allclose(pt.drift.numpy(), np.asarray(pj.drift),
                               atol=1e-5)
    cj = jm.check_paired_centers(pj, 1.5, k=6)
    ct = tm.check_paired_centers(pt, 1.5, k=6)
    np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask))
    assert int(ct.n_pairs) == int(cj.n_pairs) < int(pj.n_pairs)
    np.testing.assert_allclose(ct.drift.numpy(), np.asarray(cj.drift),
                               atol=1e-5)


def test_generate_bleed_profile_matches_jax():
    """tests/test_profiles.py's scene: the same mixing field within 1e-4
    (slopes of ~0.1 from the same fits, an f32 SVD solve and a per-pixel
    inverse)."""
    obs = _bleed_scene()
    kw = dict(th_seeds=[500.0, 500.0], rsq_th=0.5, min_spots=5)
    want = jp.generate_bleed_profile([obs[0], obs[1]], **kw)
    got = tp.generate_bleed_profile([obs[0], obs[1]], device="cpu", **kw)
    assert got.shape == want.shape == (2, 2, 96, 96)
    assert abs(want[1, 0]).max() > 0.05            # a leak field was fitted
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_generate_bleed_profile_from_rounds_matches_jax():
    """Three single-label calibration rounds of the port's calibration scene
    (small): the same inverse field within 1e-4."""
    scene = tsyn.make_calibration_scene(shape=(10, 96, 96), n_bleed_spots=12,
                                        n_illum_stacks=0, n_beads=1,
                                        n_round_spots=1, seed=3)
    rounds = [scene.bleed_round(i, device="cpu").numpy().astype(np.float32)
              for i in range(3)]
    kw = dict(th_seeds=[500.0] * 3, rsq_th=0.5, min_spots=5)
    want = jp.generate_bleed_profile_from_rounds(rounds, **kw)
    got = tp.generate_bleed_profile_from_rounds(
        [torch.from_numpy(r) for r in rounds], **kw)
    assert got.shape == (3, 3, 96, 96)
    assert abs(want[0, 1]).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_generate_chromatic_constants_matches_jax():
    """tests/test_profiles.py's bead pair: the same n_pairs; the two shift
    fields within 1e-3 px over the whole stack (the bead fits agree within
    ~1e-5 px, and 18 pairs determine the 10 monomials' coefficients only
    that well), and the corrected target beads within 1e-3 px of JAX's
    correction (and 0.1 px of the truth)."""
    rng = np.random.default_rng(3)
    shape = (12, 128, 128)
    centers = rng.uniform(10, 118, size=(30, 3))
    centers[:, 0] = rng.uniform(3, 9, 30)
    ref_center = np.array(shape, np.float64) / 2

    def true_shift(c):
        d = c - ref_center
        return np.array([0.05 + 0.001 * d[1], 0.3 + 0.004 * d[1]
                         - 0.002 * d[2], -0.2 + 0.003 * d[2]])

    tar_centers = np.array([c + true_shift(c) for c in centers])
    kw = dict(heights=np.full(30, 3000.0), sigmas=np.tile([1.2, 1.6, 1.6],
                                                           (30, 1)),
              background=100.0)
    ref_im = jsyn.render_gaussian_spots(shape, centers, **kw) \
        .astype(np.float32)
    tar_im = jsyn.render_gaussian_spots(shape, tar_centers, **kw) \
        .astype(np.float32)
    fit_kw = dict(th_seed=400.0, max_num_seeds=64, match_cutoff=2.5)
    cj, nj = jp.generate_chromatic_constants(tar_im, ref_im, **fit_kw)
    ct, nt = tp.generate_chromatic_constants(tar_im, ref_im, device="cpu",
                                             **fit_kw)
    assert nt == nj >= 15
    rc = T(ref_center.astype(np.float32))
    grid = np.stack(np.meshgrid(*[np.linspace(0, s - 1, 6) for s in shape],
                                indexing="ij"), -1).reshape(-1, 3)
    fields = [tw.evaluate_poly_shifts(T(grid.astype(np.float32)),
                                      T(np.asarray(c, np.float32)), 2,
                                      rc).numpy() for c in (ct, cj)]
    np.testing.assert_allclose(fields[0], fields[1], atol=1e-3)
    pts = T(tar_centers.astype(np.float32))
    corr_t = tw.warp_spot_coords(pts, T(ct), rc, torch.zeros(3)).numpy()
    corr_j = np.asarray(jw.warp_spot_coords(
        jnp.asarray(tar_centers, jnp.float32), jnp.asarray(cj),
        jnp.asarray(ref_center, jnp.float32), jnp.zeros(3)))
    np.testing.assert_allclose(corr_t, corr_j, atol=1e-3)
    assert np.median(np.linalg.norm(corr_t - centers, axis=1)) < 0.1


def _profiles(rng, shape):
    chs = ("750", "647", "561")
    return {
        "illumination": {c: rng.uniform(0.5, 1, shape[1:]).astype(np.float32)
                         for c in chs},
        "bleedthrough": rng.uniform(0, 1, (3, 3) + shape[1:])
        .astype(np.float32),
        "chromatic": {c: (None if c == "647" else rng.uniform(
            -1, 1, (3,) + shape).astype(np.float32)) for c in chs},
        "chromatic_constants": {c: (None if c == "647" else rng.uniform(
            -1, 1, (3, 10)).astype(np.float32)) for c in chs},
    }


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_profile_files_cross_load(tmp_path, writer):
    """A folder written by either package loads in the other with
    identical arrays (names, layouts and pickles are shared)."""
    shape = (4, 24, 32)
    profiles = _profiles(np.random.default_rng(7), shape)
    save, load = ((jio.save_correction_profile, tio.load_correction_profile)
                  if writer == "jax" else
                  (tio.save_correction_profile, jio.load_correction_profile))
    for kind, prof in profiles.items():
        if writer == "torch" and kind == "bleedthrough":
            prof = torch.from_numpy(prof)          # tensors are accepted
        save(kind, prof, str(tmp_path), im_size=shape)
    for kind, prof in profiles.items():
        got = load(kind, str(tmp_path), im_size=shape)
        if kind == "bleedthrough":
            np.testing.assert_array_equal(got, prof)
            continue
        assert sorted(got) == sorted(prof)
        for ch, arr in prof.items():
            if arr is None:
                assert got[ch] is None
            else:
                np.testing.assert_array_equal(got[ch], arr)
