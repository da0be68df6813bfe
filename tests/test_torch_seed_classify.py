"""PyTorch port vs JAX package: the exact seeding kernels on the CPU.

The port's kernels run as their plain versions on CPU tensors; the JAX
Pallas kernels run in interpret mode, as tests/test_pallas.py runs them.
The tensor-core background blur of seed_classify.cu is held through its
arithmetic model and its band-fragment table.
Inputs are made with NumPy from a seed and handed to both packages.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from imageanalysis3_tpu import synthetic as jsyn
from imageanalysis3_tpu.ops import seeding as js
from imageanalysis3_tpu.ops.filters import gaussian_filter as jgauss
from imageanalysis3_tpu.ops.pallas_kernels import (dual_gaussian_blur,
                                                   fused_seed_classify,
                                                   level_stencil_pallas)
from imageanalysis3_tpu_torch.ops import seed_kernels as tk
from imageanalysis3_tpu_torch.ops import seeding as ts
from imageanalysis3_tpu_torch.ops.filters import (_band_matrix,
                                                  gaussian_kernel1d)

torch.set_num_threads(2)
SHAPES = [(12, 64, 256), (4, 128, 256)]


def _raw(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(50, 3000, shape).astype(np.float32)


def _planted(shape, n, seed, noise_seed):
    rng = np.random.default_rng(seed)
    truth = jsyn.sample_spot_params(shape, n, rng, min_separation=8.0,
                                    height_range=(400.0, 3000.0),
                                    sigma_jitter=0.0)
    im = jsyn.render_gaussian_spots(shape, truth["centers"],
                                    truth["heights"], truth["sigmas"],
                                    truth["background"])
    im = jsyn.poisson_camera_noise(im, np.random.default_rng(noise_seed))
    return im.astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_level_stencil_plain_matches_pallas_interpret(shape):
    """Level map and counts identical, diff within rtol 1e-6."""
    im = jnp.asarray(_raw(shape, 0))
    mx = np.asarray(jgauss(im, 0.75))
    mn = np.asarray(jgauss(im, 7.5))
    lvl_j, diff_j, cnt_j = level_stencil_pallas(
        jnp.asarray(mx), jnp.asarray(mn), 300.0, 10, interpret=True)
    lvl_t, diff_t, cnt_t = tk.level_stencil(torch.from_numpy(mx),
                                            torch.from_numpy(mn), 300.0, 10)
    assert lvl_t.dtype == torch.int8
    np.testing.assert_array_equal(lvl_t.numpy(), np.asarray(lvl_j))
    np.testing.assert_allclose(diff_t.numpy(), np.asarray(diff_j),
                               rtol=1e-6)
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    assert int(cnt_t.sum()) > 0


def _blurred_pair(shape, seed):
    im = jnp.asarray(_raw(shape, seed))
    return np.asarray(jgauss(im, 0.75)), np.asarray(jgauss(im, 7.5))


def _tie_pair(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 4, shape).astype(np.float32),
            rng.integers(0, 3, shape).astype(np.float32))


def _constant_pair(shape, seed):
    return (np.full(shape, 800.0, np.float32),
            np.full(shape, 800.0, np.float32))


@pytest.mark.parametrize("shape,edge,th,make,least", [
    ((6, 31, 203), 2, 300.0, _blurred_pair, 1),      # ny % 4 = 3
    ((1, 16, 128), 0, 300.0, _blurred_pair, 1),
    ((2, 8, 130), 0, 300.0, _blurred_pair, 1),
    ((3, 31, 203), 0, 300.0, _blurred_pair, 1),
    ((6, 31, 203), 2, 3.0, _tie_pair, 1000),
    ((4, 16, 128), 0, 3.0, _tie_pair, 100),
    ((5, 24, 64), 2, 300.0, _constant_pair, 0),
])
def test_level_stencil_plain_matches_pallas_edge_cases(shape, edge, th, make,
                                                       least):
    """Level, diff and counts equal to the Pallas kernel (interpret mode)
    on the shapes and inputs the CUDA kernel's edge handling must get
    right: ragged rows, one to three planes, tie plateaus (integer values,
    thousands of counted voxels) and a constant stack, which counts
    nothing."""
    mx, mn = make(shape, 3)
    lvl_j, diff_j, cnt_j = level_stencil_pallas(
        jnp.asarray(mx), jnp.asarray(mn), th, 10, min_edge_distance=edge,
        interpret=True)
    lvl_t, diff_t, cnt_t = tk.level_stencil(torch.from_numpy(mx),
                                            torch.from_numpy(mn), th, 10,
                                            edge)
    np.testing.assert_array_equal(lvl_t.numpy(), np.asarray(lvl_j))
    np.testing.assert_array_equal(diff_t.numpy(), np.asarray(diff_j))
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    counted = int(cnt_t.sum())
    assert counted >= least and (least or counted == 0)


@pytest.mark.parametrize("shape", SHAPES)
def test_dual_blur_plain_matches_pallas_and_gaussian_filter(shape):
    """Both blurs within rtol 2e-5 / atol 2e-2 of the Pallas kernel
    (interpret mode) and of JAX's gaussian_filter, reflect edges
    included."""
    im = _raw(shape, 1)
    fg_t, bg_t = tk.dual_gaussian_blur(torch.from_numpy(im), 0.75, 7.5)
    fg_j, bg_j = dual_gaussian_blur(jnp.asarray(im), 0.75, 7.5,
                                    interpret=True)
    for got, pallas, sigma in ((fg_t, fg_j, 0.75), (bg_t, bg_j, 7.5)):
        want = np.asarray(jgauss(jnp.asarray(im), sigma))
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                                   rtol=2e-5, atol=2e-2)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-2)


def _dual_blur_model_xy(fgz, bgz, k_fg, k_bg):
    """dual_blur.cu's arithmetic for the default taps (7, 61): fg in tap
    order (bit for bit the plain version's), bg by the split-TF32 model of
    its tensor-core passes."""
    assert (len(k_fg), len(k_bg)) == tk.MMA_TAPS
    return tk._blur_xy(fgz, k_fg), tk.blur_xy_split_tf32_plain(bgz, k_bg)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("full_range", [False, True])
def test_dual_blur_model_matches_pallas_and_plain(monkeypatch, shape,
                                                  full_range):
    """The tensor-core dual blur's model lies within the JAX tests' rtol
    2e-5 / atol 2e-2 (tests/test_pallas.py) of the Pallas dual blur in
    interpret mode and of the port's plain version, over the whole uint16
    range too; its fg equals the plain version's bit for bit."""
    rng = np.random.default_rng(12)
    lo, hi = (0, 65536) if full_range else (50, 3000)
    im = rng.integers(lo, hi, shape).astype(np.float32)
    fg_p, bg_p = tk.dual_gaussian_blur(torch.from_numpy(im), 0.75, 7.5)
    monkeypatch.setattr(tk, "dual_blur_xy_plain", _dual_blur_model_xy)
    fg_m, bg_m = tk.dual_gaussian_blur(torch.from_numpy(im), 0.75, 7.5)
    fg_j, bg_j = dual_gaussian_blur(jnp.asarray(im), 0.75, 7.5,
                                    interpret=True)
    assert torch.equal(fg_m, fg_p)
    assert not torch.equal(bg_m, bg_p)       # the model is another sum
    for got, pallas, plain in ((fg_m, fg_j, fg_p), (bg_m, bg_j, bg_p)):
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                                   rtol=2e-5, atol=2e-2)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-5,
                                   atol=2e-2)


def test_get_seeds_dual_blur_model_matches_jax(monkeypatch):
    """get_seeds(filt_size=5) on the tensor-core dual blur's model gives
    JAX's seed set, count and threshold; heights (fg - bg) within the dual
    blur's rtol 2e-5 / atol 2e-2."""
    im = _planted((12, 128, 256), 24, 4, 5)
    kw = dict(max_num_seeds=64, th_seed=300.0, filt_size=5)
    s_j = js.get_seeds(jnp.asarray(im), **kw)
    monkeypatch.setattr(tk, "dual_blur_xy_plain", _dual_blur_model_xy)
    s_t = ts.get_seeds(torch.from_numpy(im), pyramid_bg=False, **kw)
    c_t = s_t.coords.numpy()[s_t.valid.numpy()]
    c_j = np.asarray(s_j.coords)[np.asarray(s_j.valid)]
    assert len(c_t) == len(c_j) >= 20
    o_t, o_j = np.lexsort(c_t.T[::-1]), np.lexsort(c_j.T[::-1])
    np.testing.assert_array_equal(c_t[o_t], c_j[o_j])
    h_t = s_t.heights.numpy()[s_t.valid.numpy()][o_t]
    h_j = np.asarray(s_j.heights)[np.asarray(s_j.valid)][o_j]
    np.testing.assert_allclose(h_t, h_j, rtol=2e-5, atol=2e-2)
    assert int(s_t.count) == int(s_j.count)
    assert float(s_t.threshold) == float(s_j.threshold)


def test_dual_blur_model_counts_nothing_on_a_constant_stack():
    """On a flat stack the split products need not give equal bg values, so
    voxels may pass minimum_filter(bg, 5) != bg; their diff is ~0, which is
    level n_lvl and never counted, and no seed comes out."""
    shape = (12, 64, 128)
    im = torch.full(shape, 800.0)
    k_fg, k_bg = gaussian_kernel1d(0.75), gaussian_kernel1d(7.5)
    fg, bg = _dual_blur_model_xy(im, im, k_fg, k_bg)
    q, c = ts._classify_from_blurs(fg, bg, 300.0, 0, shape[1], shape, 5, 2,
                                   10)
    assert int(c.sum()) == 0
    fin = torch.isfinite(q)
    assert not fin.any() or float(q[fin].abs().max()) < 0.05


def _check_classifier(q_t, c_t, q_ref, c_ref):
    """tests/test_pallas.py's tolerances for the fused classifier."""
    q_ref = np.asarray(q_ref)
    same_qual = np.isfinite(q_t) == np.isfinite(q_ref)
    assert same_qual.mean() > 1 - 1e-5
    both = np.isfinite(q_t) & np.isfinite(q_ref)
    assert both.sum() > 0
    np.testing.assert_allclose(q_t[both], q_ref[both], rtol=1e-4, atol=0.05)
    assert abs(int(c_t.sum()) - int(np.asarray(c_ref).sum())) <= 2


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("reference", ["pallas_interpret", "level_diff_hist"])
def test_fused_classify_plain_matches_jax(shape, reference):
    """Qualification agrees on > 1 - 1e-5 of voxels, qdiff within rtol
    1e-4 / atol 0.05, counts within 2: against the Pallas kernel in
    interpret mode and against the unfused seeding._level_diff_hist."""
    im = _raw(shape, 7)
    q_t, c_t = tk.fused_seed_classify(torch.from_numpy(im), 0.75, 7.5,
                                      300.0, 10, min_edge_distance=2)
    assert c_t.dtype == torch.int32 and c_t.shape == (10,)
    if reference == "pallas_interpret":
        q_j, c_j = fused_seed_classify(jnp.asarray(im), 0.75, 7.5, 300.0,
                                       10, min_edge_distance=2,
                                       interpret=True)
    else:
        q_j, c_j = js._level_diff_hist(jnp.asarray(im), 300.0, 0, shape[1],
                                       shape, 0.75, 7.5, 3, 2, 10)
    _check_classifier(q_t.numpy(), c_t, q_j, c_j)


def test_tf32_split_rounds_to_ten_bits_and_recovers_the_value():
    """hi's low 13 mantissa bits are zero (so are lo's), hi + lo is within
    2^-22 relative of x, and hi rounds to nearest: for the default 7- and
    61-tap kernels and random f32."""
    rng = np.random.default_rng(3)
    x = np.concatenate([
        gaussian_kernel1d(0.75), gaussian_kernel1d(7.5),
        rng.uniform(-65535.0, 65535.0, 4096).astype(np.float32),
        (rng.standard_normal(4096) * 1e-3).astype(np.float32)])
    hi, lo = (t.numpy() for t in tk.tf32_split(torch.from_numpy(x)))
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert not (lo.view(np.uint32) & 0x1FFF).any()
    x64 = x.astype(np.float64)
    assert (np.abs(hi.astype(np.float64) + lo - x64)
            <= 2.0 ** -22 * np.abs(x64)).all()
    assert (np.abs(hi - x64) <= 2.0 ** -11 * np.abs(x64)).all()
    # a tie rounds away from zero, as cvt.rna does
    tie = np.array([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)], np.float32)
    np.testing.assert_array_equal(
        tk.tf32_split(torch.from_numpy(tie))[0].numpy(),
        np.array([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)], np.float32))


def _band_from_fragments(table, k):
    """The dense bands a kernel reading tk.band_fragments multiplies
    by, hi + lo, put together as the kernel puts its fragments together:
    A (16, 8 chunks) of the x pass and, from the chunks an 8-column tile
    needs, B (8 chunks, 8) of the y pass."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    d = table[:, :, 0] + table[:, :, 2]
    e = table[:, :, 1] + table[:, :, 3]
    zero = np.zeros(32, np.float32)
    n_a, n_b = table.shape[0], tk.band_chunks(k, 8)
    a = np.zeros((16, 8 * n_a), np.float32)
    b = np.zeros((8 * n_b, 8), np.float32)
    for c in range(n_a):
        a[g, 8 * c + t] = d[c]
        a[g + 8, 8 * c + t] = d[c - 1] if c else zero
        a[g, 8 * c + t + 4] = e[c]
        a[g + 8, 8 * c + t + 4] = e[c - 1] if c else zero
    for c in range(n_b):
        b[8 * c + t, g] = d[c]
        b[8 * c + t + 4, g] = e[c]
    return a, b


@pytest.mark.parametrize("sigma", [0.75, 7.5])
def test_band_fragments_rebuild_the_toeplitz_band(sigma):
    """The per-lane mma fragments handed to the kernel, put back into dense
    matrices, are the Toeplitz band of the taps (filters._band_matrix's
    interior rows) to within hi + lo's 2^-22, the same for every row tile
    and column tile; every entry is a TF32 value."""
    taps = gaussian_kernel1d(sigma)
    k, r = len(taps), len(taps) // 2
    table = tk.band_fragments(taps)
    assert table.shape == (tk.band_chunks(k, 16), 32, 4)
    assert table.dtype == np.float32
    assert not (table.view(np.uint32) & 0x1FFF).any()
    a, b = _band_from_fragments(table, k)
    assert b.shape == (8 * tk.band_chunks(k, 8), 8)
    n = 4 * k + 64
    w = _band_matrix(n, tuple(taps.tolist()), "reflect")
    for i0 in (r, r + 16, r + 32, n - r - 16):      # row tiles of the x pass
        want = np.zeros_like(a)
        width = min(a.shape[1], n - (i0 - r))
        want[:, :width] = w[i0:i0 + 16, i0 - r:i0 - r + width]
        np.testing.assert_allclose(a, want, rtol=2.0 ** -22, atol=0)
    for j0 in (r, r + 8, r + 24, n - r - 8):        # column tiles of the y
        want = np.zeros_like(b)
        depth = min(b.shape[0], n - (j0 - r))
        want[:depth] = w[j0:j0 + 8, j0 - r:j0 - r + depth].T
        np.testing.assert_allclose(b, want, rtol=2.0 ** -22, atol=0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("full_range", [False, True])
def test_split_tf32_blur_model_within_tolerance_of_tap_order(shape,
                                                             full_range):
    """The tensor-core bg blur's arithmetic model against the tap-ordered
    blur: rtol 1e-5 / atol 5e-3 for inputs 50-3000 (the split keeps ~2^-22
    of each operand), and inside the classifier's atol 0.05 over the whole
    uint16 range, reflect edges included."""
    rng = np.random.default_rng(8)
    lo, hi = (0, 65536) if full_range else (50, 3000)
    im = torch.from_numpy(rng.integers(lo, hi, shape).astype(np.float32))
    k_bg = gaussian_kernel1d(7.5)
    got = tk.blur_xy_split_tf32_plain(im, k_bg).numpy()
    want = tk._blur_xy(im, k_bg).numpy()
    if full_range:
        np.testing.assert_allclose(got, want, rtol=0, atol=0.05)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=5e-3)


def _model_classify(im, min_edge_distance=2):
    """The exact classifier as seed_classify.cu computes it for the default
    taps: fg passes in tap order, bg passes by the split-TF32 model."""
    k_fg, k_bg = gaussian_kernel1d(0.75), gaussian_kernel1d(7.5)
    fgz, bgz = tk.z_pass_pair(torch.from_numpy(im), k_fg, k_bg)
    q, c = tk.classify_blurred(tk._blur_xy(fgz, k_fg),
                               tk.blur_xy_split_tf32_plain(bgz, k_bg),
                               300.0, 10, min_edge_distance)
    return (fgz, bgz, k_fg, k_bg), q, c


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("reference", ["plain", "pallas_interpret",
                                       "level_diff_hist"])
def test_split_tf32_classifier_model_matches_references(shape, reference):
    """The classifier on the model's bg meets the fused classifier's
    tolerances against the port's plain version, the Pallas kernel in
    interpret mode and the unfused seeding._level_diff_hist."""
    im = _raw(shape, 7)
    zpassed, q_m, c_m = _model_classify(im)
    if reference == "plain":
        q_r, c_r = tk.fused_seed_classify_plain(*zpassed, 300.0, 10, 2)
        q_r, c_r = q_r.numpy(), c_r.numpy()
    elif reference == "pallas_interpret":
        q_r, c_r = fused_seed_classify(jnp.asarray(im), 0.75, 7.5, 300.0,
                                       10, min_edge_distance=2,
                                       interpret=True)
    else:
        q_r, c_r = js._level_diff_hist(jnp.asarray(im), 300.0, 0, shape[1],
                                       shape, 0.75, 7.5, 3, 2, 10)
    _check_classifier(q_m.numpy(), c_m, q_r, c_r)


def test_split_tf32_classifier_model_counts_nothing_on_a_constant_stack():
    """On a flat stack the split products need not give equal bg values, so
    voxels may pass min3 != bg; their diff is ~0, which is level n_lvl and
    is never counted."""
    _, q, c = _model_classify(np.full((6, 64, 128), 800.0, np.float32))
    assert int(c.sum()) == 0
    fin = torch.isfinite(q)
    assert not fin.any() or float(q[fin].abs().max()) < 0.05


def test_fused_classify_plain_equals_its_blur_parts():
    """The fused plain version is the z-pass pair, the dual x+y blur and
    the in-range 3^3 stencil, bit for bit (min_edge_distance 1 reaches the
    last row and column, whose x/y neighbours lie outside)."""
    im = torch.from_numpy(_planted((6, 64, 128), 6, 2, 3))
    k_fg, k_bg = gaussian_kernel1d(0.75), gaussian_kernel1d(7.5)
    fgz, bgz = tk.z_pass_pair(im, k_fg, k_bg)
    q, c = tk.fused_seed_classify_plain(fgz, bgz, k_fg, k_bg, 300.0, 10, 1)
    fg, bg = tk.dual_blur_xy_plain(fgz, bgz, k_fg, k_bg)
    q2, c2 = ts._classify_from_blurs(fg, bg, 300.0, 0, 64, (6, 64, 128), 3,
                                     1, 10)
    assert torch.equal(q, q2) and torch.equal(c, c2)
    assert int(c.sum()) > 0


@pytest.mark.parametrize("filt_size", [3, 5])
def test_get_seeds_exact_matches_jax(filt_size):
    """pyramid_bg=False: the port's fused classifier (filt_size 3) or dual
    blur (filt_size 5) gives JAX's seed set, heights, count and
    threshold."""
    im = _planted((12, 128, 256), 24, 4, 5)
    kw = dict(max_num_seeds=64, th_seed=300.0, filt_size=filt_size)
    s_j = js.get_seeds(jnp.asarray(im), **kw)
    s_t = ts.get_seeds(torch.from_numpy(im), pyramid_bg=False, **kw)
    c_t = s_t.coords.numpy()[s_t.valid.numpy()]
    c_j = np.asarray(s_j.coords)[np.asarray(s_j.valid)]
    assert len(c_t) == len(c_j) >= 20
    o_t, o_j = np.lexsort(c_t.T[::-1]), np.lexsort(c_j.T[::-1])
    np.testing.assert_array_equal(c_t[o_t], c_j[o_j])
    h_t = s_t.heights.numpy()[s_t.valid.numpy()][o_t]
    h_j = np.asarray(s_j.heights)[np.asarray(s_j.valid)][o_j]
    np.testing.assert_allclose(h_t, h_j, rtol=1e-5)
    assert int(s_t.count) == int(s_j.count)
    assert float(s_t.threshold) == float(s_j.threshold)


@pytest.mark.parametrize("kw,path", [
    (dict(), "fused_seed_classify"),
    (dict(filt_size=5), "dual_gaussian_blur"),
    (dict(min_edge_distance=0), "dual_gaussian_blur"),
    (dict(slab_x=16), None),
    (dict(pyramid_bg=True), "fused_seed_classify_pyramid"),
])
def test_get_seeds_dispatch_follows_config(monkeypatch, kw, path):
    """The config picks the classifier in the JAX package's order."""
    called = []
    for name in ("fused_seed_classify", "dual_gaussian_blur",
                 "fused_seed_classify_pyramid"):
        fn = getattr(ts, name)
        monkeypatch.setattr(ts, name, lambda *a, _n=name, _f=fn, **k:
                            called.append(_n) or _f(*a, **k))
    ts.get_seeds(torch.from_numpy(_planted((6, 64, 128), 4, 6, 7)),
                 max_num_seeds=16, **kw)
    assert called == ([path] if path else [])


@pytest.mark.parametrize("wrapper,args", [
    ("level_stencil_cuda", lambda t: (t, t, 300.0, 10, 2)),
    ("dual_blur_xy_cuda", lambda t: (t, t, gaussian_kernel1d(0.75),
                                     gaussian_kernel1d(7.5))),
    ("fused_seed_classify_cuda", lambda t: (t, t, gaussian_kernel1d(0.75),
                                            gaussian_kernel1d(7.5), 300.0,
                                            10, 2)),
])
def test_cuda_wrappers_refuse_cpu_tensors(wrapper, args):
    t = torch.zeros((4, 16, 16))
    before = dict(tk.launches)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(tk, wrapper)(*args(t))
    assert tk.launches == before


@pytest.mark.parametrize("fn,args", [
    ("level_stencil", lambda t: (t, t, 300.0, 10)),
    ("dual_gaussian_blur", lambda t: (t, 0.75, 7.5)),
    ("fused_seed_classify", lambda t: (t, 0.75, 7.5, 300.0, 10)),
])
def test_dispatchers_raise_on_other_devices(fn, args):
    """Neither kernel nor plain version for a tensor on another device."""
    t = torch.zeros((4, 16, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        getattr(tk, fn)(*args(t))
