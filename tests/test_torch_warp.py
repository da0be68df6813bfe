"""PyTorch port vs JAX package: image warps, image alignment, the
2D-projection rough drift, bead alignment and the naive deconvolution, on
the CPU.  Tolerances: images rtol 1e-5 / atol 1e-2 (tests/test_warp.py's
between warp_image and scipy), drifts 1e-3 px with equal flags (one
upsample step, 0.01 px, under phase whitening), integer
drifts, pair masks and counts equal, the deconvolution rtol 1e-5 / atol
1e-3 (tests/test_torch_filters.py's for gaussian_filter)."""

import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from imageanalysis3_tpu import synthetic as jsyn
from imageanalysis3_tpu.ops import drift as jd
from imageanalysis3_tpu.ops import filters as jf
from imageanalysis3_tpu.ops import matching as jm
from imageanalysis3_tpu.ops import warp as jw
from imageanalysis3_tpu_torch.ops import drift as td
from imageanalysis3_tpu_torch.ops import filters as tf
from imageanalysis3_tpu_torch.ops import matching as tm
from imageanalysis3_tpu_torch.ops import warp as tw

torch.set_num_threads(2)
SHAPE = (10, 48, 56)


def _im(seed=9, shape=SHAPE, n=12):
    im, _ = jsyn.random_spot_field(shape, n, np.random.default_rng(seed),
                                   min_separation=8.0)
    return im.astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-2)


def test_trilinear_map_coordinates_matches_jax():
    """The 8-tap gather at random points, many outside the stack (edge
    clamping)."""
    im = _im()
    coords = np.random.default_rng(1).uniform(
        -3, 60, (3, 4, 50, 7)).astype(np.float32)
    coords[0] *= 0.2
    _close(tw.trilinear_map_coordinates(torch.from_numpy(im),
                                        torch.from_numpy(coords)),
           jw.trilinear_map_coordinates(im, coords))


def test_trilinear_map_coordinates_near_2048_matches_jax():
    """The gather at y = 2040..2099 (a full-width frame's last columns) on
    values up to 6e4, sampled at the grid less the drift (0.6, -1.4, 2.3):
    its f32 coordinates round by up to 1.2e-4 px there, in both packages
    alike.  The two agree to 7.8e-3 (two f32 ulps at 6e4); held at atol
    1e-2, rtol 0."""
    im = np.random.default_rng(13).uniform(0, 6e4, (6, 40, 2100)).astype(
        np.float32)
    d = np.array([0.6, -1.4, 2.3], np.float32)
    grid = np.stack(np.meshgrid(np.arange(6), np.arange(40),
                                np.arange(2040, 2100), indexing="ij"))
    coords = (grid - d[:, None, None, None]).astype(np.float32)
    got = tw.trilinear_map_coordinates(torch.from_numpy(im),
                                       torch.from_numpy(coords))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jw.trilinear_map_coordinates(im, coords)),
        rtol=0, atol=1e-2)


@pytest.mark.parametrize("drift", [(0.5, 1.25, -0.75), (-2.3, 7.6, 0.0),
                                   (12.0, -0.01, 3.99)])
def test_warp_image_drift_matches_jax_and_the_gather(drift):
    """Drift only: warp_image = warp_image_drift = the 8-tap gather at the
    shifted grid, and the JAX package's warp."""
    im = _im()
    d = np.asarray(drift, np.float32)
    got = tw.warp_image(torch.from_numpy(im), d)
    _close(got, jw.warp_image(im, d))
    assert torch.equal(got, tw.warp_image_drift(torch.from_numpy(im), d))
    grid = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float32)
                                  for s in SHAPE], indexing="ij"))
    _close(got, tw.trilinear_map_coordinates(
        torch.from_numpy(im), torch.from_numpy(grid - d[:, None, None, None])))


@pytest.mark.parametrize("plane_pixels", [1, 3 * 48 * 56, 1 << 22])
@pytest.mark.parametrize("mcs", [4, 2])
def test_warp_image_chromatic_matches_jax(mcs, plane_pixels, monkeypatch):
    """Order-2 chromatic constants whose shifts reach past
    max_chromatic_shift at the edges (clipped on both sides), with a drift,
    for several plane batches."""
    im = _im(seed=4)
    consts = np.zeros((3, 10), np.float32)
    consts[:, 0] = [0.3, -1.1, 0.8]
    consts[0, 2] = 0.02
    consts[1, 2] = 0.05
    consts[1, 7] = 2e-3
    consts[2, 3] = -0.06
    consts[2, 9] = 3e-3
    center = np.array([5.0, 24.0, 28.0], np.float32)
    d = np.array([0.6, -1.4, 2.3], np.float32)
    edge = np.array([[0, 0, 0], [9, 47, 55], [0, 47, 0]], np.float32)
    reach = np.abs(np.asarray(jw.evaluate_poly_shifts(
        edge, consts, 2, center))).max()
    assert reach > mcs, reach
    monkeypatch.setattr(tw, "PLANE_PIXELS", plane_pixels)
    got = tw.warp_image(torch.from_numpy(im), d, consts, center,
                        max_chromatic_shift=mcs)
    want = jw.warp_image(im, d, consts, center, max_chromatic_shift=mcs)
    _close(got, want)


@pytest.fixture(scope="module")
def moved_pair():
    im = _im(seed=2, shape=(16, 96, 96), n=40)
    mov = ndi.shift(im, (0.6, -1.4, 2.3), order=1,
                    mode="nearest").astype(np.float32)
    return im, mov


@pytest.mark.parametrize("kw", [dict(drift_size=48),
                                dict(drift_size=40, upsample_factor=20,
                                     window=None),
                                dict(drift_size=48, normalization="phase",
                                     subtract_mean=False)])
def test_align_image_matches_jax(moved_pair, kw):
    """Drift within 1e-3 px of the JAX package's and the same flag; under
    phase whitening (which weights near-empty frequencies fully, so the two
    FFT libraries' rounding moves the peak) within one upsample step, the
    tolerance of tests/test_torch_pipeline.py's round drift."""
    ref, mov = moved_pair
    got, flag = td.align_image(mov, ref, device="cpu", **kw)
    want, wflag = jd.align_image(mov, ref, **kw)
    tol = 0.0100001 if kw.get("normalization") == "phase" else 1e-3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol)
    assert int(flag) == int(wflag)
    if len(kw) == 1:        # the defaults: within 0.1 px of the truth
        np.testing.assert_allclose(got.numpy(), [-0.6, 1.4, -2.3], atol=0.1)


def test_align_image_takes_given_crops_and_tensors(moved_pair):
    ref, mov = moved_pair
    crops = td.generate_drift_crops(ref.shape, 40)[:5]
    got, flag = td.align_image(torch.from_numpy(mov), torch.from_numpy(ref),
                               crops=crops)
    want, wflag = jd.align_image(mov, ref, crops=crops)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    assert int(flag) == int(wflag)


@pytest.mark.parametrize("shift", [(2, -5, 7), (0, 0, 0), (-3, 11, -20)])
def test_fft3d_from2d_matches_jax(moved_pair, shift):
    ref, _ = moved_pair
    src = np.roll(ref, shift, axis=(0, 1, 2))
    got = td.fft3d_from2d(src, ref, device="cpu")
    want = np.asarray(jd.fft3d_from2d(src, ref))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, -np.asarray(shift, np.float32))


def _pad(a, n):
    out = np.zeros((n, 3), np.float32)
    out[:len(a)] = a
    v = np.zeros(n, bool)
    v[:len(a)] = True
    return out, v


@pytest.mark.parametrize("check,n_beads", [(True, 12), (False, 12),
                                           (True, 3)])
def test_align_beads_matches_jax(check, n_beads):
    """The JAX test's sparse bead scene; with 3 beads the checked pairing
    keeps too few pairs and both fall back to the unchecked one."""
    r = np.random.default_rng(7)
    shape = (12, 96, 96)
    centers = r.uniform(12, 80, size=(n_beads, 3)).astype(np.float32)
    centers[:, 0] = r.uniform(3, 9, n_beads)
    disp = np.array([1.0, 3.3, -2.6], np.float32)
    heights = np.full(n_beads, 3000.0)
    sigmas = np.tile([1.2, 1.6, 1.6], (n_beads, 1))
    ref_im = jsyn.render_gaussian_spots(shape, centers, heights, sigmas,
                                        background=100.0).astype(np.float32)
    tar_im = jsyn.render_gaussian_spots(shape, centers + disp, heights,
                                        sigmas,
                                        background=100.0).astype(np.float32)
    tar_cts, tar_v = _pad(centers + disp, 16)
    ref_cts, ref_v = _pad(centers, 16)
    want = jm.align_beads(tar_cts, tar_v, ref_cts, ref_v, tar_im, ref_im,
                          match_distance_th=2.0, check=check)
    got = tm.align_beads(*map(torch.from_numpy, (tar_cts, tar_v, ref_cts,
                                                 ref_v)),
                         tar_im, ref_im, match_distance_th=2.0, check=check)
    np.testing.assert_allclose(got.drift.numpy(), np.asarray(want.drift),
                               atol=1e-3)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert int(got.n_pairs) == int(want.n_pairs)
    np.testing.assert_allclose(got.drift.numpy(), -disp, atol=0.1)


@pytest.mark.parametrize("gfilt_size,niter", [(2.0, 1), (1.5, 2)])
def test_gaussian_deconvolution_matches_jax(gfilt_size, niter):
    im = _im(seed=3) + 1.0
    got = tf.gaussian_deconvolution(torch.from_numpy(im), gfilt_size, niter)
    want = jf.gaussian_deconvolution(im, gfilt_size, niter)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-3)
