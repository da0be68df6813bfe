"""PyTorch port vs JAX package: seeding on the CPU.

The port's pyramid classifier runs its plain version on CPU tensors; the
JAX Pallas kernel runs in interpret mode, as tests/test_pallas.py runs it.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from imageanalysis3_tpu import synthetic as jsyn
from imageanalysis3_tpu.ops import seeding as js
from imageanalysis3_tpu.ops.pallas_kernels import fused_seed_classify_pyramid
from imageanalysis3_tpu_torch.ops import seed_kernels as tk
from imageanalysis3_tpu_torch.ops import seeding as ts
from imageanalysis3_tpu_torch.ops.filters import gaussian_kernel1d

torch.set_num_threads(2)


def _planted(shape, n, seed, noise_seed):
    """Planted Gaussian spots with seeded NumPy camera noise, as f32."""
    rng = np.random.default_rng(seed)
    truth = jsyn.sample_spot_params(shape, n, rng, min_separation=8.0,
                                    height_range=(400.0, 3000.0),
                                    sigma_jitter=0.0)
    im = jsyn.render_gaussian_spots(shape, truth["centers"],
                                    truth["heights"], truth["sigmas"],
                                    truth["background"])
    im = jsyn.poisson_camera_noise(im, np.random.default_rng(noise_seed))
    return im.astype(np.float32), truth


@pytest.mark.parametrize("shape,n", [((12, 128, 256), 30),
                                     ((6, 64, 128), 8)])
def test_pyramid_plain_matches_pallas_interpret(shape, n):
    """Selected sets identical, signal within rtol 1e-4 / atol 0.05 on the
    selected voxels (the TPU kernel's bf16-split interpolation), counts
    within 2 -- including a thin stack (z < 8: band-matrix z-pass)."""
    im, _ = _planted(shape, n, 0, 1)
    q_j, c_j = fused_seed_classify_pyramid(jnp.asarray(im), 0.75, 7.5,
                                           300.0, 10, min_edge_distance=2,
                                           interpret=True)
    q_t, c_t = tk.fused_seed_classify_pyramid(torch.from_numpy(im), 0.75,
                                              7.5, 300.0, 10,
                                              min_edge_distance=2)
    q_j, q_t = np.asarray(q_j), q_t.numpy()
    sel_j = np.isfinite(q_j) & (q_j >= 300.0)
    sel_t = np.isfinite(q_t) & (q_t >= 300.0)
    np.testing.assert_array_equal(sel_t, sel_j)
    assert sel_j.sum() >= n - 3
    np.testing.assert_allclose(q_t[sel_j], q_j[sel_j], rtol=1e-4, atol=0.05)
    assert abs(int(c_t.sum()) - int(np.asarray(c_j).sum())) <= 2


def test_pyramid_flat_plateau_gives_no_candidates():
    im = torch.full((8, 64, 128), 800.0)
    q, counts = tk.fused_seed_classify_pyramid(im, 0.75, 7.5, 10.0, 10)
    assert int(counts.sum()) == 0
    fin = torch.isfinite(q)
    assert not fin.any() or bool((q[fin] < -1e6).all())


def test_bilinear_upsample_matches_tpu_weights():
    """The plain upsample equals the TPU kernel's explicit interpolation
    matrices (_up_x_matrix/_up_y_matrix with two edge lead-in cells)."""
    from imageanalysis3_tpu.ops.pallas_kernels import (_up_x_matrix,
                                                       _up_y_matrix)
    rng = np.random.default_rng(2)
    xs, ys = 16, 24
    bgs = rng.uniform(100, 200, (3, xs, ys)).astype(np.float32)
    got = tk.upsample_background(torch.from_numpy(bgs), 4 * xs,
                                 4 * ys).numpy()
    bxe = 4 * xs + 8
    ux = _up_x_matrix(bxe).astype(np.float64)         # ring rows X0-4+t
    uy = _up_y_matrix(ys + 4, 4 * ys).astype(np.float64)
    pad = np.pad(bgs.astype(np.float64), ((0, 0), (2, 2), (2, 2)),
                 mode="edge")
    want = np.einsum("tr,zrc->ztc", ux[:, :xs + 4],
                     np.einsum("zrl,lc->zrc", pad, uy))[:, 4:4 + 4 * xs]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_pyramid_cuda_wrapper_refuses_cpu_tensors():
    im = torch.zeros((4, 16, 16))
    bgs = torch.zeros((4, 4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        tk.fused_seed_classify_pyramid_cuda(im, bgs, gaussian_kernel1d(0.75),
                                            300.0, 10, 2)


def _compare_seed_tables(s_t, s_j, heights=True):
    c_t = s_t.coords.numpy()[s_t.valid.numpy()]
    c_j = np.asarray(s_j.coords)[np.asarray(s_j.valid)]
    assert len(c_t) == len(c_j) > 0
    order_t = np.lexsort(c_t.T[::-1])
    order_j = np.lexsort(c_j.T[::-1])
    np.testing.assert_array_equal(c_t[order_t], c_j[order_j])
    if heights:
        h_t = s_t.heights.numpy()[s_t.valid.numpy()][order_t]
        h_j = np.asarray(s_j.heights)[np.asarray(s_j.valid)][order_j]
        np.testing.assert_allclose(h_t, h_j, rtol=1e-5)


@pytest.mark.parametrize("slab_x", [1024, 32])
def test_get_seeds_exact_matches_jax(slab_x):
    """pyramid_bg=False: the exact classifier in plain PyTorch gives JAX's
    seed set, heights, count and threshold (slab_x=32 takes the x-slab
    path on a 128-wide stack)."""
    im, _ = _planted((12, 128, 128), 20, 3, 4)
    kw = dict(max_num_seeds=64, th_seed=300.0, slab_x=slab_x)
    s_j = js.get_seeds(jnp.asarray(im), **kw)
    s_t = ts.get_seeds(torch.from_numpy(im), pyramid_bg=False, **kw)
    _compare_seed_tables(s_t, s_j)
    assert int(s_t.count) == int(s_j.count)
    assert float(s_t.threshold) == float(s_j.threshold)
    assert bool(s_t.saturated) == bool(s_j.saturated)


def test_get_seeds_dynamic_threshold_matches_jax():
    """A threshold no spot reaches decays to the same level in both."""
    im, _ = _planted((12, 128, 128), 10, 5, 6)
    kw = dict(max_num_seeds=16, th_seed=6000.0, min_dynamic_seeds=3)
    s_j = js.get_seeds(jnp.asarray(im), **kw)
    s_t = ts.get_seeds(torch.from_numpy(im), pyramid_bg=False, **kw)
    assert float(s_t.threshold) == float(s_j.threshold) < 6000.0
    _compare_seed_tables(s_t, s_j)


def test_get_seeds_pyramid_matches_jax_planted_set():
    """pyramid_bg=True (the port's default path on every device) recovers
    the same planted seed set as JAX's get_seeds (exact classifier on the
    CPU), as tests/test_pallas.py asserts for the TPU kernel."""
    im, _ = _planted((12, 256, 256), 30, 3, 2)
    s_j = js.get_seeds(jnp.asarray(im), max_num_seeds=64, th_seed=300.0)
    s_t = ts.get_seeds(torch.from_numpy(im), max_num_seeds=64,
                       th_seed=300.0, pyramid_bg=True)
    _compare_seed_tables(s_t, s_j, heights=False)
