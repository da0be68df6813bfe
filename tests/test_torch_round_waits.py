"""The round's host code without waits on the card for its own constants.

Each constant an op used to copy from the host on every call comes from
``device.device_constant`` (built and copied once a key) or from a fill on
the device.  Every such site is held here, bit for bit, to the construction
it replaced, kept inline; ``consensus_drift``, which now indexes on the
device, to a NumPy transcription of its vote; the cache to its contract;
and a recorded round to its count of the constants it built."""

import math

import numpy as np
import pytest
import torch

from imageanalysis3_tpu_torch import device as tdev
from imageanalysis3_tpu_torch import synthetic as tsyn
from imageanalysis3_tpu_torch import tracing
from imageanalysis3_tpu_torch.config import (ExperimentConfig, FitConfig,
                                             SeedConfig)
from imageanalysis3_tpu_torch.ops import drift, filters, gaussian_fit, seeding
from imageanalysis3_tpu_torch.pipeline import FovPipeline

torch.set_num_threads(2)


@pytest.fixture
def empty_cache():
    """The constant cache emptied before and after the test."""
    tdev._consts.clear()
    yield
    tdev._consts.clear()


def _equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


# ---- each site against the construction it replaced ----------------------

@pytest.mark.parametrize("mode", ["nearest", "reflect", "mirror", "wrap",
                                  "constant"])
@pytest.mark.parametrize("n,lo,hi", [(9, 2, 3), (9, 3, 2), (5, 7, 1),
                                     (1, 3, 3)])
def test_pad_axis_equals_index_copied_from_host(mode, n, lo, hi):
    im = torch.arange(4 * n * 3, dtype=torch.float32).reshape(4, n, 3)
    got = filters._pad_axis(im, 1, lo, hi, mode, -5.0)
    if mode == "constant":
        want = torch.full((4, n + lo + hi, 3), -5.0)
        want[:, lo:lo + n] = im
    else:
        idx = filters._map_boundary_index(np.arange(-lo, n + hi), n, mode)
        want = im.index_select(1, torch.from_numpy(idx).to(im.device))
    assert _equal(got, want)
    assert _equal(filters._pad_axis(im, 1, lo, hi, mode, -5.0), got)


@pytest.mark.parametrize("mode", ["reflect", "nearest"])
@pytest.mark.parametrize("n", [30, 2048])
def test_band_path_equals_matrix_copied_from_host(mode, n):
    """The 61-tap pass (sigma 7.5, the seeding background) takes the band
    matrix, now kept on the device."""
    kernel = filters.gaussian_kernel1d(7.5)
    assert len(kernel) == 61
    im = torch.from_numpy(np.random.default_rng(n).uniform(
        0, 1000, (2, 3, n)).astype(np.float32))
    got = filters._conv1d_along_axis(im, kernel, 2, mode)
    w = torch.from_numpy(filters._band_matrix(
        n, tuple(np.asarray(kernel, np.float32).tolist()), mode)).to(
            im.device)
    with filters.full_f32_matmul():
        want = torch.matmul(im, w.T)
    assert _equal(got, want)


def _upsampled_argmax_copied(R, ny_full, center, upsample, npoints):
    """``drift._upsampled_argmax`` as it was: 2*pi and the y weights made
    on the host and copied on every call."""
    k, nz, nx, ny_half = R.shape
    dev = R.device

    def axis_kernel(n, c):
        m = npoints // 2
        freqs = torch.fft.fftfreq(n, d=1.0 / n, device=dev).to(torch.float32)
        offs = (torch.arange(npoints, device=dev, dtype=torch.float32) - m) \
            / upsample
        s = c[:, None] + offs[None, :]
        two_pi = torch.tensor(2 * math.pi, dtype=torch.float32, device=dev)
        theta = (two_pi * s)[..., None] * freqs / n
        return torch.polar(torch.ones_like(theta), theta)

    Wz = axis_kernel(nz, center[:, 0])
    Wx = axis_kernel(nx, center[:, 1])
    m = npoints // 2
    freqs_y = torch.arange(ny_half, dtype=torch.float32, device=dev)
    offs = (torch.arange(npoints, device=dev, dtype=torch.float32) - m) \
        / upsample
    s = center[:, 2, None] + offs[None, :]
    two_pi = torch.tensor(2 * math.pi, dtype=torch.float32, device=dev)
    theta = (two_pi * s)[..., None] * freqs_y / ny_full
    w = torch.full((ny_half,), 2.0, device=dev)
    w[0] = 1.0
    if ny_full % 2 == 0:
        w[-1] = 1.0
    Wy = torch.polar(torch.ones_like(theta), theta) * w
    with filters.full_f32_matmul():
        t = torch.einsum("kaz,kzxy->kaxy", Wz, R)
        t = torch.einsum("kbx,kaxy->kaby", Wx, t)
        t = torch.einsum("kcy,kaby->kabc", Wy, t)
    mag = t.real.abs().reshape(k, -1)
    flat = mag.argmax(dim=1)
    idx = torch.stack([flat // (npoints * npoints),
                       (flat // npoints) % npoints,
                       flat % npoints], dim=1).to(torch.float32)
    return center + (idx - m) / upsample


@pytest.mark.parametrize("ny_full", [8, 9, 2, 1])
def test_upsampled_argmax_equals_constants_copied_from_host(ny_full):
    rng = np.random.default_rng(ny_full)
    ny_half = ny_full // 2 + 1
    R = torch.from_numpy((rng.normal(size=(3, 6, 7, ny_half))
                          + 1j * rng.normal(size=(3, 6, 7, ny_half))
                          ).astype(np.complex64))
    center = torch.from_numpy(rng.uniform(-2, 2, (3, 3)).astype(np.float32))
    for upsample, npoints in ((10.0, 15), (100.0, 17)):
        want = _upsampled_argmax_copied(R, ny_full, center, upsample, npoints)
        got = drift._upsampled_argmax(R, ny_full, center, upsample, npoints)
        assert _equal(got, want)


@pytest.mark.parametrize("shape", [(6, 10, 12), (5, 9, 7)])
def test_phase_correlation_equals_peak_size_copied_from_host(shape):
    """The integer stage's peak wrap: the view's size, now kept on the
    device, against the size copied from the host (``upsample_factor`` 1
    returns the wrapped peak itself)."""
    rng = np.random.default_rng(sum(shape))
    a = torch.from_numpy(rng.normal(size=(2,) + shape).astype(np.float32))
    b = torch.roll(a, (1, -2, 3), dims=(1, 2, 3))
    F_a, F_b = torch.fft.rfftn(a, dim=(-3, -2, -1)), torch.fft.rfftn(
        b, dim=(-3, -2, -1))
    got = drift._phase_correlate_spectrum(F_a, F_b, shape, 1, None, None)
    cc = torch.fft.irfftn(F_a * torch.conj(F_b), s=shape,
                          dim=(-3, -2, -1)).abs()
    flat = cc.reshape(2, -1).argmax(dim=1)
    z, x, y = shape
    peak = torch.stack([flat // (x * y), (flat // y) % x, flat % y],
                       dim=1).to(torch.float32)
    size = torch.tensor(shape, dtype=torch.float32, device=cc.device)
    assert _equal(got, torch.where(peak > size / 2, peak - size, peak))


# the fills: a float32 value (or an int) filled on the device is the tensor
# copied from the host, so a fill replaces the copy at these sites
@pytest.mark.parametrize("value,dtype", [
    (400.0, torch.float32), (600.0, torch.float32),
    (float(np.float32(150.7)), torch.float32),
    (float(np.float32(1e-6)), torch.float32),
    (float(np.float32(3.3e38)), torch.float32),
    (0, torch.int32), (7, torch.int32), (10, torch.int32)])
def test_fill_equals_tensor_copied_from_host(value, dtype):
    assert _equal(torch.full((), value, dtype=dtype),
                  torch.tensor(value, dtype=dtype))


@pytest.mark.parametrize("th_seed,dynamic", [(400.0, True), (600.0, True),
                                             (150.7, False), (0.0, True)])
def test_get_seeds_threshold_equals_scale_copied_from_host(th_seed, dynamic):
    """The dynamic threshold and the seeds in budget, with the scale
    filled on the device, against the scale copied from the host."""
    rng = np.random.default_rng(5)
    im = torch.from_numpy(rng.uniform(100, 900, (8, 40, 36)).astype(
        np.float32))
    got = seeding.get_seeds(im, max_num_seeds=32, th_seed=th_seed,
                            use_dynamic_th=dynamic, min_dynamic_seeds=20)
    n_lvl = 10 if dynamic else 1
    th_f = float(max(np.float32(th_seed), np.float32(1e-6)))
    chosen = torch.round(
        (1.0 - got.threshold / th_f) * n_lvl).to(torch.float32)
    want = torch.tensor(th_f, dtype=torch.float32) * (1.0 - chosen / n_lvl)
    assert _equal(got.threshold, want)
    assert int(got.count) > 0


@pytest.mark.parametrize("init_w", [1.5, 2.25])
def test_init_params_rest_equals_row_copied_from_host(init_w):
    rng = np.random.default_rng(6)
    pixels = torch.from_numpy(rng.uniform(50, 500, (9, 30)).astype(
        np.float32))
    mask = torch.from_numpy(rng.uniform(size=(9, 30)) > 0.2)
    got = gaussian_fit.init_params(pixels, mask, 0.5, 4.0, init_w)
    wsq = init_w * init_w
    wg = float(np.log(np.float32((16.0 - wsq) / (wsq - 0.25))))
    rest = torch.tensor([wg, wg, wg, 0.0, 0.0], dtype=torch.float32,
                        device=pixels.device).expand(9, 5)
    assert _equal(got[:, 5:], rest)
    assert _equal(gaussian_fit.init_params(pixels, mask, 0.5, 4.0, init_w),
                  got)


@pytest.fixture(scope="module")
def fitted():
    fov = tsyn.make_synthetic_fov(shape=(10, 64, 64), n_rounds=1,
                                  n_channels=1, n_spots=14, seed=8,
                                  drift_scale=0.0)
    im = torch.from_numpy(fov.ims[0, 0].astype(np.float32))
    seeds = seeding.get_seeds(im, max_num_seeds=16, th_seed=200.0)
    outs = [gaussian_fit.iter_fit_seed_points(
        im, seeds.coords.to(torch.float32), seeds.valid, radius=7,
        lm_iters=6, n_max_iter=n) for n in (0, 2)]
    return im, seeds, outs


@pytest.mark.parametrize("which", [0, 1])
def test_iter_fit_rounds_and_valid_equal_copied_from_host(fitted, which):
    im, seeds, outs = fitted
    res = outs[which]
    want_rounds = torch.tensor(int(res.n_rounds), dtype=torch.int32,
                               device=im.device)
    assert _equal(res.n_rounds, want_rounds)
    nat = res.spots
    size = torch.tensor(im.shape, dtype=torch.float32, device=im.device)
    inside = ((nat[:, 1:4] > 0) & (nat[:, 1:4] < size)).all(dim=1)
    _, _, base_mask = gaussian_fit.gather_blocks(
        im, seeds.coords.to(torch.float32), 7)
    base_mask = base_mask & seeds.valid[:, None]
    enough_px = base_mask.to(torch.int32).sum(dim=1) > 10
    want_valid = (seeds.valid & torch.isfinite(nat).all(dim=1) & inside
                  & enough_px)
    assert _equal(res.valid, want_valid)
    assert bool(res.valid.any())


# ---- consensus_drift indexes on the device ------------------------------

def _consensus_np(d, th, min_good):
    """The vote in NumPy float32: the first best-agreeing drift's group
    mean (flag 0), else the mean of the first closest pair and the first
    drift closest to both (flag 1)."""
    d = np.asarray(d, np.float32)
    k = d.shape[0]
    d2 = ((d[:, None] - d[None, :]) ** 2).sum(axis=-1)
    agree = d2 <= np.float32(th) ** 2
    counts = agree.sum(axis=1)
    best = int(np.argmax(counts))
    n_good = counts[best]
    good_mean = (np.where(agree[best][:, None], d, np.float32(0)).sum(axis=0)
                 / np.float32(max(n_good, 1)))
    d2 = np.where(np.eye(k, dtype=bool), np.float32(np.inf), d2)
    i, j = divmod(int(np.argmin(d2)), k)
    third = d2[:, i] + d2[:, j]
    third[[i, j]] = np.inf
    t = int(np.argmin(third))
    fallback = (d[i] + d[j] + d[t]) * np.float32(1.0 / 3.0)
    ok = n_good >= min_good
    return (good_mean if ok else fallback), (0 if ok else 1)


def _drift_sets():
    rng = np.random.default_rng(9)
    agreeing = np.array([[0.1, 1.0, -2.0], [0.15, 1.1, -2.05],
                         [5.0, 3.0, 1.0], [0.05, 0.95, -1.9],
                         [-4.0, 2.0, 0.0]])
    # two groups of three agree: the first best-agreeing drift wins
    tied_groups = np.array([[0, 0, 0], [0.5, 0, 0], [0, 0.5, 0],
                            [9, 9, 9], [9.5, 9, 9], [9, 9.5, 9]])
    # every pair as close, every third drift as far: first pair, first third
    tied_pairs = np.array([[0, 0, 0], [3, 0, 0], [0, 3, 0], [0, 0, 3],
                           [-3, 0, 0], [0, -3, 0], [0, 0, -3], [3, 3, 3]])
    return {"random": rng.uniform(-10, 10, (8, 3)),
            "agreeing": agreeing,
            "disagreeing": rng.uniform(-10, 10, (3, 3)),
            "tied_groups": tied_groups,
            "tied_pairs": tied_pairs,
            "one": np.array([[0.25, -0.5, 1.0]]),
            "all_equal": np.full((4, 3), 1.5)}


@pytest.mark.parametrize("min_good", [3, 2])
@pytest.mark.parametrize("name", list(_drift_sets()))
def test_consensus_drift_equals_numpy_vote(name, min_good):
    d = _drift_sets()[name].astype(np.float32)
    got, flag = drift.consensus_drift(torch.from_numpy(d),
                                      min_good_drifts=min_good)
    want, want_flag = _consensus_np(d, 1.0, min_good)
    np.testing.assert_array_equal(got.numpy(), want)
    assert flag.dtype == torch.int32 and flag.shape == ()
    assert int(flag) == want_flag


def test_consensus_drift_sets_give_both_flags():
    flags = {_consensus_np(d.astype(np.float32), 1.0, 3)[1]
             for d in _drift_sets().values()}
    assert flags == {0, 1}


# ---- the cache ----------------------------------------------------------

def test_cache_keeps_one_tensor_a_key_dtype_and_device(empty_cache):
    built = []

    def build():
        built.append(1)
        return [1.0, 2.0, 3.0]

    a = tdev.device_constant(("t",), torch.float32, "cpu", build)
    assert tdev.device_constant(("t",), torch.float32, "cpu", build) is a
    b = tdev.device_constant(("t",), torch.float64, "cpu", build)
    c = tdev.device_constant(("t",), torch.float32, "meta", build)
    d = tdev.device_constant(("u",), torch.float32, "cpu", build)
    assert len({id(a), id(b), id(c), id(d)}) == 4
    assert (b.dtype, c.device.type) == (torch.float64, "meta")
    assert len(built) == 4 and len(tdev._consts) == 4
    assert _equal(a, torch.tensor([1.0, 2.0, 3.0]))
    # the build's own array is not the cached tensor's memory
    src = np.arange(3, dtype=np.float32)
    e = tdev.device_constant(("v",), torch.float32, "cpu", lambda: src)
    src[0] = 9.0
    assert float(e[0]) == 0.0


def test_cache_stays_within_its_bounds(empty_cache, monkeypatch):
    for i in range(tdev.CONST_ENTRIES + 20):
        tdev.device_constant(("n", i), torch.int64, "cpu", lambda: [i])
    assert len(tdev._consts) == tdev.CONST_ENTRIES
    # the least recently used went first
    assert (("n", 0), torch.int64, torch.device("cpu")) not in tdev._consts
    assert (("n", tdev.CONST_ENTRIES + 19), torch.int64,
            torch.device("cpu")) in tdev._consts
    tdev._consts.clear()
    monkeypatch.setattr(tdev, "CONST_BYTES", 4096)

    def big(i):
        return tdev.device_constant(("big", i), torch.float32, "cpu",
                                    lambda: np.full(512, i, np.float32))

    first = big(0)
    big(1)
    assert big(0) is first                    # used last: kept
    big(2)
    nbytes = sum(t.untyped_storage().nbytes() for t in tdev._consts.values())
    assert nbytes <= 4096
    assert [k[0] for k in tdev._consts] == [("big", 0), ("big", 2)]
    # larger than the bound alone: built, returned, not kept
    huge = tdev.device_constant(("huge",), torch.float32, "cpu",
                                lambda: np.zeros(2048, np.float32))
    assert huge.numel() == 2048
    assert all(k[0] != ("huge",) for k in tdev._consts)


# ---- a recorded round ---------------------------------------------------

SHAPE = (10, 64, 64)


@pytest.fixture(scope="module")
def scene():
    fov = tsyn.make_synthetic_fov(shape=SHAPE, n_rounds=3, n_channels=2,
                                  n_spots=20, seed=11, drift_scale=1.5)
    ims = torch.from_numpy(np.clip(fov.ims, 0, 65535).astype(np.int32))
    cfg = ExperimentConfig(image_size=SHAPE,
                           fit=FitConfig(radius=7, lm_iters=6, n_max_iter=2),
                           seed=SeedConfig(th_seed=300.0, max_num_seeds=16))
    pipe = FovPipeline(cfg, n_channels=2, drift_channel_index=1,
                       fit_channel_indices=(0, 1),
                       illumination=fov.illumination.astype(np.float32),
                       image_shape=SHAPE, device="cpu")
    ref = pipe.prepare_reference(pipe.correct_reference(ims[0]))
    return pipe, ref, ims


def test_round_counts_the_constants_it_builds(scene, empty_cache):
    """The first round of its shapes builds its constants, the second
    builds none and gives the bits the first would; nothing writes into a
    kept constant."""
    pipe, ref, ims = scene
    tracing.clear()
    with tracing.recording():
        first = pipe.process_round(ims[1], ref)
        second = pipe.process_round(ims[2], ref)
    rounds = tracing.record().rounds
    tracing.clear()
    assert [g[0].name for g in rounds] == [tracing.ROUND] * 2
    builds = [g[0].attrs["const_builds"] for g in rounds]
    assert builds[0] > 0 and builds[1] == 0
    assert builds[0] == len(tdev._consts)
    assert all(t._version == 0 for t in tdev._consts.values())
    # the sites left that wait on the card (none of them waits on the CPU)
    sites = {s.attrs["site"] for g in rounds for s in g if s.name == "sync"}
    assert sites <= {"refit_check", "drift_flag"}
    tdev._consts.clear()
    again = pipe.process_round(ims[2], ref)
    for a, b in zip(again, second):
        assert torch.equal(a, b)
    assert first.spots.shape == second.spots.shape
