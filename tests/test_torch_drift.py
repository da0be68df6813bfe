"""PyTorch port vs JAX package: drift registration on the CPU."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from imageanalysis3_tpu import synthetic as jsyn
from imageanalysis3_tpu.ops import drift as jd
from imageanalysis3_tpu_torch.ops import drift as td

torch.set_num_threads(2)


@pytest.mark.parametrize("shape,size", [((60, 2048, 2048), 512),
                                        ((12, 128, 128), 64),
                                        ((7, 100, 90), None)])
def test_generate_drift_crops_exact(shape, size):
    np.testing.assert_array_equal(td.generate_drift_crops(shape, size),
                                  jd.generate_drift_crops(shape, size))


def _beads(shape, shift, seed):
    rng = np.random.default_rng(seed)
    truth = jsyn.sample_spot_params(shape, 14, rng, min_separation=6.0,
                                    height_range=(2000.0, 6000.0))
    ref = jsyn.render_gaussian_spots(shape, truth["centers"],
                                     truth["heights"], truth["sigmas"],
                                     background=120.0)
    mov = jsyn.render_gaussian_spots(shape, truth["centers"] + shift,
                                     truth["heights"], truth["sigmas"],
                                     background=120.0)
    noise = np.random.default_rng(seed + 1)
    ref = jsyn.poisson_camera_noise(ref, noise)
    mov = jsyn.poisson_camera_noise(mov, noise)
    return ref.astype(np.float32), mov.astype(np.float32)


@pytest.mark.parametrize("window", [None, "hann_xy", "hann"])
def test_prepare_ref_spectrum_matches_jax(window):
    ref, _ = _beads((8, 32, 40), np.zeros(3), 0)
    want = np.asarray(jd.prepare_ref_spectrum(jnp.asarray(ref),
                                              subtract_mean=True,
                                              window=window))
    got = td.prepare_ref_spectrum(torch.from_numpy(ref), subtract_mean=True,
                                  window=window).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("shift", [(0.6, 1.3, -2.7), (-1.25, 0.4, 0.9)])
def test_subpixel_drift_matches_jax(shift):
    """A known sub-pixel shift registers to JAX's answer within one
    upsample grid step (0.01 px)."""
    ref, mov = _beads((10, 48, 48), np.asarray(shift), 2)
    kw = dict(upsample_factor=100, subtract_mean=True, window="hann_xy")
    want = np.asarray(jd.subpixel_phase_correlation(
        jnp.asarray(ref), jnp.asarray(mov), **kw))
    got = td.subpixel_phase_correlation(torch.from_numpy(ref),
                                        torch.from_numpy(mov), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=0.0100001)
    np.testing.assert_allclose(got, -np.asarray(shift), atol=0.15)


def test_batched_prepared_matches_single():
    ref, mov = _beads((8, 32, 32), np.asarray([0.5, -1.0, 1.5]), 3)
    refs = torch.from_numpy(np.stack([ref, ref[:, ::-1].copy()]))
    movs = torch.from_numpy(np.stack([mov, mov[:, ::-1].copy()]))
    spec = td.prepare_ref_spectrum(refs, True, "hann_xy")
    batched = td.subpixel_phase_correlation_prepared(
        spec, movs, subtract_mean=True, window="hann_xy")
    for k in range(2):
        single = td.subpixel_phase_correlation(
            refs[k], movs[k], subtract_mean=True, window="hann_xy")
        np.testing.assert_array_equal(batched[k].numpy(), single.numpy())


@pytest.mark.parametrize("case", ["consensus", "fallback"])
def test_consensus_drift_exact(case):
    rng = np.random.default_rng(4)
    if case == "consensus":
        d = np.array([[0.1, 1.0, -2.0], [0.15, 1.1, -2.05], [5.0, 3.0, 1.0],
                      [0.05, 0.95, -1.9], [-4.0, 2.0, 0.0]], np.float32)
    else:
        d = rng.uniform(-10, 10, (8, 3)).astype(np.float32)
    want, wflag = jd.consensus_drift(jnp.asarray(d))
    got, gflag = td.consensus_drift(torch.from_numpy(d))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(gflag) == int(wflag) == (0 if case == "consensus" else 1)
