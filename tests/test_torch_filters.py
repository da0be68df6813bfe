"""PyTorch port vs JAX package: filters, medians and corrections on the CPU.

The same seeded NumPy inputs go through both packages; tolerances are f32
summation-order noise unless the operation is exact (min/max, medians).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from imageanalysis3_tpu.ops import corrections as jc
from imageanalysis3_tpu.ops import filters as jf
from imageanalysis3_tpu_torch.ops import corrections as tc
from imageanalysis3_tpu_torch.ops import filters as tf

torch.set_num_threads(2)


def _stack(shape=(8, 40, 48), seed=0, hi=3000.0):
    return np.random.default_rng(seed).uniform(0, hi, shape).astype(
        np.float32)


@pytest.mark.parametrize("sigma,mode,truncate", [
    (0.75, "reflect", 4.0),
    (7.5, "reflect", 4.0),
    ((1.35, 1.9, 1.9), "reflect", 4.0),
    (3.0, "nearest", 2.0),
])
def test_gaussian_filter_matches_jax(sigma, mode, truncate):
    im = _stack()
    want = np.asarray(jf.gaussian_filter(jnp.asarray(im), sigma,
                                         truncate=truncate, mode=mode))
    got = tf.gaussian_filter(torch.from_numpy(im), sigma, truncate=truncate,
                             mode=mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_short_axis_repeated_reflection():
    """A kernel wider than the axis (radius 30 on 5 planes) reflects
    repeatedly, as the JAX band matrix does."""
    im = _stack((5, 16, 16), seed=1)
    want = np.asarray(jf.gaussian_filter(jnp.asarray(im), 7.5))
    got = tf.gaussian_filter(torch.from_numpy(im), 7.5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("op,mode", [("max", "reflect"), ("min", "reflect"),
                                     ("max", "nearest"), ("min", "mirror")])
def test_window_filters_exact(op, mode):
    im = np.random.default_rng(2).integers(0, 50, (6, 20, 24)).astype(
        np.float32)
    want = np.asarray(jf._window_reduce(jnp.asarray(im), 3, mode, op))
    got = tf._window_reduce(torch.from_numpy(im), 3, mode, op).numpy()
    np.testing.assert_array_equal(got, want)
    want_i = np.asarray(jf._window_reduce_interior(jnp.asarray(im), 3, op))
    got_i = tf._window_reduce_interior(torch.from_numpy(im), 3, op).numpy()
    np.testing.assert_array_equal(got_i, want_i)


def test_maximum_minimum_filter_exact():
    im = _stack((6, 20, 24), seed=3)
    np.testing.assert_array_equal(
        tf.maximum_filter(torch.from_numpy(im), 3).numpy(),
        np.asarray(jf.maximum_filter(jnp.asarray(im), 3)))
    np.testing.assert_array_equal(
        tf.minimum_filter(torch.from_numpy(im), 3).numpy(),
        np.asarray(jf.minimum_filter(jnp.asarray(im), 3)))


@pytest.mark.parametrize("subsample", [1, 16])
@pytest.mark.parametrize("hi", [4000, 65535])
def test_counting_median_layers_and_global_exact(subsample, hi):
    """Fixed 18 iterations == the JAX while_loop, on quarter-integer data
    spanning up to the full uint16 range."""
    rng = np.random.default_rng(4)
    im = (rng.integers(0, hi * 4, (5, 64, 48)) / 4.0).astype(np.float32)
    wl, wg = jf.counting_median_layers_and_global(jnp.asarray(im),
                                                  subsample=subsample)
    gl, gg = tf.counting_median_layers_and_global(torch.from_numpy(im),
                                                  subsample=subsample)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    assert float(gg) == float(wg)


def test_counting_median_exact():
    im = (np.random.default_rng(5).integers(0, 8000, (4, 9, 11)) / 4.0
          ).astype(np.float32)
    for axis in (None, 0, (1, 2)):
        want = np.asarray(jf.counting_median(jnp.asarray(im), axis=axis))
        got = tf.counting_median(torch.from_numpy(im), axis=axis).numpy()
        np.testing.assert_array_equal(got, want)


def test_gaussian_highpass_matches_jax():
    im = _stack((6, 32, 32), seed=6)
    want = np.asarray(jf.gaussian_highpass(jnp.asarray(im), 3.0, 2.0))
    got = tf.gaussian_highpass(torch.from_numpy(im), 3.0, 2.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def _camera(shape, seed):
    rng = np.random.default_rng(seed)
    im = rng.normal(500, 30, shape)
    im[:, 5, 7] = 9000.0                       # a hot column
    im[: shape[0] // 3, 9, 3] = 9000.0         # hot in too few layers
    return np.clip(im, 0, 65535).astype(np.uint16)


def test_remove_hot_pixels_matches_jax():
    im = _camera((6, 24, 20), 7)
    want = np.asarray(jc.remove_hot_pixels(jnp.asarray(im)))
    got = tc.remove_hot_pixels(torch.from_numpy(im.astype(np.int32)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert got[0, 5, 7] < 1000


def test_z_shift_correct_matches_jax():
    im = _camera((6, 24, 20), 8).astype(np.float32)
    im *= np.linspace(0.8, 1.2, 6)[:, None, None].astype(np.float32)
    for s in (1, 4):
        want = np.asarray(jc.z_shift_correct(jnp.asarray(im),
                                             median_subsample=s))
        got = tc.z_shift_correct(torch.from_numpy(im),
                                 median_subsample=s).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("n_ch,bleed,sequential", [
    (1, False, False), (3, True, False), (3, True, True)])
def test_correct_channel_stack_matches_jax(n_ch, bleed, sequential):
    rng = np.random.default_rng(9)
    shape = (6, 24, 20)
    ims = np.stack([_camera(shape, 10 + c) for c in range(n_ch)])
    illum = rng.uniform(0.6, 1.0, (n_ch,) + shape[1:]).astype(np.float32)
    prof = None
    if bleed:
        m = np.eye(n_ch) + 0.05 * rng.uniform(size=(n_ch, n_ch))
        prof = np.broadcast_to(m[:, :, None, None],
                               (n_ch, n_ch) + shape[1:]).astype(np.float32)
    kw = dict(do_bleedthrough=bleed, median_subsample=1,
              sequential_channels=sequential)
    want = np.asarray(jc.correct_channel_stack(
        jnp.asarray(ims), None if prof is None else jnp.asarray(prof),
        jnp.asarray(illum), **kw))
    got = tc.correct_channel_stack(
        torch.from_numpy(ims.astype(np.int32)),
        None if prof is None else torch.from_numpy(prof),
        torch.from_numpy(illum), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_deinterleave_matches_jax():
    raw = np.arange(23 * 4 * 5, dtype=np.uint16).reshape(23, 4, 5)
    want = np.asarray(jc.deinterleave_stack(jnp.asarray(raw), (1, 2), 3, 6))
    got = tc.deinterleave_stack(torch.from_numpy(raw.astype(np.int32)),
                                (1, 2), 3, 6).numpy()
    np.testing.assert_array_equal(got, want)


def _band_calls():
    """gaussian_filter's band matmul (25 taps: one per axis) and the seeding
    z pass: 4 matmuls."""
    from imageanalysis3_tpu_torch.ops import seed_kernels as sk
    tf.gaussian_filter(torch.from_numpy(_stack()), 3.0)
    sk.z_pass_pair(torch.from_numpy(_stack()), tf.gaussian_kernel1d(0.75),
                   tf.gaussian_kernel1d(7.5))


def _bleed_call():
    rng = np.random.default_rng(1)
    tc.bleedthrough_unmix(
        torch.from_numpy(rng.uniform(0, 1e3, (2, 3, 4, 5)).astype(np.float32)),
        torch.from_numpy(rng.uniform(0, 1, (2, 2, 4, 5)).astype(np.float32)))


def _dft_call():
    from imageanalysis3_tpu_torch.ops import drift
    rng = np.random.default_rng(2)
    spec = rng.normal(size=(2, 6, 8, 5)) + 1j * rng.normal(size=(2, 6, 8, 5))
    drift._upsampled_argmax(torch.from_numpy(spec.astype(np.complex64)), 8,
                            torch.zeros((2, 3)), 10.0, 15)


def _poly_call():
    from imageanalysis3_tpu_torch.ops import warp
    rng = np.random.default_rng(3)
    warp.evaluate_poly_shifts(
        torch.from_numpy(rng.uniform(0, 50, (6, 3)).astype(np.float32)),
        torch.from_numpy(rng.normal(size=(3, 10)).astype(np.float32)), 2,
        torch.full((3,), 25.0))


def _lm_call():
    from imageanalysis3_tpu_torch.ops import lm_kernel
    rng = np.random.default_rng(4)
    n, p = 3, 40
    lm_kernel.lm_fit_plain(
        torch.from_numpy(rng.uniform(100, 900, (n, p)).astype(np.float32)),
        torch.from_numpy(rng.uniform(0, 10, (n, p, 3)).astype(np.float32)),
        torch.ones((n, p), dtype=torch.bool), torch.full((n, 3), 5.0),
        torch.full((n,), 2.0),
        torch.from_numpy((rng.normal(0, 0.1, (n, 10)) + [5, 6, 0, 0, 0, 0.3,
                          0.3, 0.3, 0, 0]).astype(np.float32)),
        0.5, 4.0, lm_iters=1)


#: each call with the products the reference runs at Precision.HIGHEST
#: (matmul, or an einsum by its equation) and how many of them it makes
_HIGHEST_CALLS = {
    "band": (_band_calls, {"matmul": 4}),
    "bleedthrough_unmix": (_bleed_call, {"ijxy,jzxy->izxy": 1}),
    "upsampled_dft": (_dft_call, {"kaz,kzxy->kaxy": 1, "kbx,kaxy->kaby": 1,
                                  "kcy,kaby->kabc": 1}),
    "evaluate_poly_shifts": (_poly_call, {"nm,dm->nd": 1}),
    "lm_fit_plain": (_lm_call, {"nip,np->ni": 1, "nip,njp->nij": 1}),
}


@pytest.mark.parametrize("api,call", [
    pytest.param(api, call, id=api if call == "band" else f"{api}-{call}")
    for call in _HIGHEST_CALLS for api in ("legacy", "fp32_precision")])
def test_band_matmuls_run_full_f32_and_restore_the_setting(monkeypatch,
                                                           api, call):
    """With the caller's TF32 on (through either of PyTorch's two APIs),
    every product the reference runs at HIGHEST (the band matmuls of
    gaussian_filter and the seeding z pass, bleedthrough unmixing, the
    upsampled DFT, the chromatic polynomial, the LM's g and H) runs with it
    off, and the caller's setting is back after each call."""
    flags = torch.backends.cuda.matmul
    fn, want = _HIGHEST_CALLS[call]
    seen = []
    real_matmul, real_einsum = torch.matmul, torch.einsum

    def state():
        return (flags.fp32_precision if api == "fp32_precision"
                else flags.allow_tf32)

    def spy_matmul(*args, **kw):
        seen.append(("matmul", state()))
        return real_matmul(*args, **kw)

    def spy_einsum(eq, *args, **kw):
        seen.append((eq, state()))
        return real_einsum(eq, *args, **kw)

    before = torch.get_float32_matmul_precision()
    try:
        if api == "legacy":
            torch.set_float32_matmul_precision("high")
        else:
            flags.fp32_precision = "tf32"
        monkeypatch.setattr(torch, "matmul", spy_matmul)
        monkeypatch.setattr(torch, "einsum", spy_einsum)
        fn()
        after = (flags.fp32_precision if api == "fp32_precision"
                 else torch.get_float32_matmul_precision())
    finally:
        monkeypatch.undo()
        if api == "fp32_precision":
            flags.fp32_precision = "none"
        torch.set_float32_matmul_precision(before)
    off = "ieee" if api == "fp32_precision" else False
    got = [(k, v) for k, v in seen if k in want]
    assert sorted(got) == sorted((k, off) for k, n in want.items()
                                 for _ in range(n))
    assert after == ("tf32" if api == "fp32_precision" else "high")


def _band_matrix_loop(n, kernel, mode):
    """The per-element loop the vectorised band matrix replaced: each tap's
    source index by scalar repeated reflection, summed in (row, tap)
    order in float64."""
    def source(idx):
        if mode == "constant":
            return idx if 0 <= idx < n else None
        if mode == "wrap":
            return idx % n
        for _ in range(64):
            if 0 <= idx < n:
                return idx
            if mode == "nearest":
                idx = min(max(idx, 0), n - 1)
            elif mode == "reflect":
                idx = -idx - 1 if idx < 0 else 2 * n - 1 - idx
            else:
                idx = -idx if idx < 0 else 2 * n - 2 - idx
        return min(max(idx, 0), n - 1)

    k = np.asarray(kernel, np.float64)
    w = np.zeros((n, n), np.float64)
    for i in range(n):
        for t in range(len(k)):
            s = source(i + t - len(k) // 2)
            if s is not None:
                w[i, s] += k[t]
    return w.astype(np.float32)


@pytest.mark.parametrize("mode", ["reflect", "nearest", "mirror", "constant",
                                  "wrap"])
def test_band_matrix_equals_per_element_loop(mode):
    """Bit for bit, short axes (radius > n, repeated reflection) included."""
    for n in (1, 2, 5, 30, 97):
        for sigma in (0.75, 3.0, 7.5):
            k = tf.gaussian_kernel1d(sigma)
            np.testing.assert_array_equal(
                tf._band_matrix(n, tuple(k.tolist()), mode),
                _band_matrix_loop(n, k, mode))
