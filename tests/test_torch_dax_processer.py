"""PyTorch port vs JAX package: ``DaxProcesser`` step by step on one small
written movie pair, ``batch_process_image_quick`` with a profile the JAX
package saved, and ``FovPipeline.process_round_raw`` / ``process_rounds``.

Tolerances: images rtol 1e-5 / atol 1e-2 (tests/test_warp.py's); the
loaded stacks exactly; drifts within one upsample step (0.01 px) with
equal flags, as tests/test_torch_pipeline.py holds a round's drift (on
these noisy crops one crop of eight can land one grid step apart between
the two FFT libraries); fits as
tests/test_torch_pipeline.py holds them (equal valid masks, centres and
widths 1e-3 px, heights rtol 1e-2)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageanalysis3_tpu import synthetic as jsyn
from imageanalysis3_tpu.config import ExperimentConfig, FitConfig, SeedConfig
from imageanalysis3_tpu.io.profiles_io import save_correction_profile
from imageanalysis3_tpu.pipeline import FovPipeline as JaxPipeline
from imageanalysis3_tpu.pipeline import dax_processer as jdp
from imageanalysis3_tpu_torch.convert import pipeline_from_arrays
from imageanalysis3_tpu_torch.io import dax as tdax
from imageanalysis3_tpu_torch.io.native_loader import load_dax_channels
from imageanalysis3_tpu_torch.pipeline import dax_processer as tdp

torch.set_num_threads(2)
SHAPE = (10, 96, 96)
CHANNELS = ["750", "647", "488"]
BUF = 4
DRIFT = np.array([0.6, -1.4, 2.3])
FIT = dict(th_seed=400.0, max_num_seeds=32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-2)


@pytest.fixture(scope="module")
def movies(tmp_path_factory):
    """Rounds H0 and H1 (H1's content moved by DRIFT) of 2 spot channels
    and a bead channel, camera noise and a few hot pixels, written by the
    port; the truth centres of each data channel in H0's frame."""
    rng = np.random.default_rng(11)
    truths = [jsyn.sample_spot_params(SHAPE, n, rng, min_separation=10.0,
                                      height_range=(1500.0, 4000.0))
              for n in (10, 10, 24)]
    root = tmp_path_factory.mktemp("movies")
    paths = []
    for r, shift in enumerate((np.zeros(3), DRIFT)):
        stacks = []
        for c, t in enumerate(truths):
            im = jsyn.render_gaussian_spots(SHAPE, t["centers"] + shift,
                                            t["heights"], t["sigmas"], 120.0)
            im = jsyn.poisson_camera_noise(im, rng)
            im[:, 7 + c, 30] = 60000.0           # a hot column
            stacks.append(im.astype(np.uint16))
        path = str(root / f"H{r}.dax")
        tdax.write_dax(path, tdax.interleave_channels(stacks,
                                                      buffer_frames=BUF))
        paths.append(path)
    return paths, [t["centers"] for t in truths[:2]]


def _pair(path, **kw):
    kw = dict(all_channels=CHANNELS, single_im_size=SHAPE,
              num_buffer_frames=BUF, **kw)
    return jdp.DaxProcesser(path, **kw), tdp.DaxProcesser(path, device="cpu",
                                                          **kw)


def test_find_helpers_match_jax(movies):
    path = movies[0][0]
    for args in ((path, 3, BUF), (path, 2, BUF), (path, 3, 0, 2)):
        assert tdp.DaxProcesser._FindImageSize(*args) == \
            jdp.DaxProcesser._FindImageSize(*args)
    for kw in (dict(single_im_size=SHAPE, num_buffer_frames=BUF),
               dict(num_buffer_frames=BUF), dict(num_buffer_frames=0)):
        assert tdp.DaxProcesser._FindDaxChannels(path, **kw) == \
            jdp.DaxProcesser._FindDaxChannels(path, **kw)
    assert dataclasses.asdict(tdp.DaxProcesser._LoadInfFile(path)) == \
        dataclasses.asdict(jdp.DaxProcesser._LoadInfFile(path))
    # geometry inferred from the file, as the JAX facade infers it
    auto_t = tdp.DaxProcesser(path, num_buffer_frames=BUF, device="cpu")
    auto_j = jdp.DaxProcesser(path, num_buffer_frames=BUF)
    assert auto_t.all_channels == auto_j.all_channels
    assert auto_t.single_im_size == auto_j.single_im_size


def test_corrections_step_by_step_with_ledger(movies):
    """load, hot pixels, z shift, illumination, bleedthrough, high-pass:
    each step's ims against the JAX facade's; a repeated step is a no-op
    (the same tensors), and steps mark only the channels they touch."""
    jp, tp = _pair(movies[0][0], correction_channels=["750", "647"])
    jp._load_image()
    tp._load_image()
    for ch in ("750", "647"):
        assert tp.ims[ch].dtype == torch.float32
        np.testing.assert_array_equal(tp.ims[ch].numpy(), jp.ims[ch])
    assert tp.correction_log == jp.correction_log
    prof = jsyn.illumination_profile(SHAPE[1:], falloff=0.4)
    bleed = np.zeros((2, 2) + SHAPE[1:], np.float32)
    bleed[0, 0] = bleed[1, 1] = 1.05
    bleed[0, 1] = bleed[1, 0] = -0.04
    steps = [("_corr_hot_pixels_3D", ()), ("_corr_Z_shift", ()),
             ("_corr_illumination", ({"750": prof},)),
             ("_corr_bleedthrough", (bleed,)),
             ("_gaussian_highpass", ())]
    for name, args in steps:
        getattr(jp, name)(*args)
        getattr(tp, name)(*args)
        for ch in ("750", "647"):
            _close(tp.ims[ch], jp.ims[ch])
        assert tp.correction_log == jp.correction_log, name
        before = dict(tp.ims)
        getattr(tp, name)(*args)
        assert all(tp.ims[ch] is before[ch] for ch in before), name
    assert not tp.correction_log["647"].get("illumination")
    assert tp.correction_log["750"]["illumination"]
    tp._load_image()
    assert tp.ims["750"] is before["750"]


@pytest.fixture(scope="module")
def drifted(movies):
    """H1 loaded, hot pixels removed and registered against H0's corrected
    bead channel in both packages."""
    paths, truth = movies
    ref_j, ref_t = _pair(paths[0], correction_channels=["488"])
    for p in (ref_j, ref_t):
        p._load_image()._corr_hot_pixels_3D()
    jp, tp = _pair(paths[1])
    for p in (jp, tp):
        p._load_image()._corr_hot_pixels_3D()
    dj = jp._calculate_drift(ref_j.ims["488"], drift_size=48)
    dt = tp._calculate_drift(ref_t.ims["488"], drift_size=48)
    assert isinstance(dt, torch.Tensor) and tp.drift is dt
    # the later steps start from the same drift, carried across, so they
    # compare the warps' and fits' arithmetic
    tp.drift = torch.from_numpy(np.array(dj, np.float32))
    return jp, tp, dj, dt, truth


def test_calculate_drift_matches_jax(drifted):
    jp, tp, dj, dt, _ = drifted
    np.testing.assert_allclose(dt.numpy(), dj, atol=0.0100001)
    assert tp.drift_flag == jp.drift_flag == 0
    np.testing.assert_allclose(dt.numpy(), -DRIFT, atol=0.1)


def _fits_match(got, want):
    vj = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), vj)
    g = got.spots.numpy()[vj]
    w = np.asarray(want.spots)[vj]
    np.testing.assert_allclose(g[:, 1:4], w[:, 1:4], atol=1e-3)
    np.testing.assert_allclose(g[:, 0], w[:, 0], rtol=1e-2)
    np.testing.assert_allclose(g[:, 5:8], w[:, 5:8], atol=1e-3)
    return g


def _matched(centers, truth, tol):
    d = np.linalg.norm(centers[:, None] - truth[None], axis=-1)
    return int((d.min(axis=0) < tol).sum())


def test_fit_and_spot_coords_match_jax(drifted):
    """The coordinate path: fits on the unwarped channels, then the drift
    (and a chromatic shift on 750) applied to the coordinates; back in
    H0's frame every planted spot is found."""
    jp, tp, _, _, truth = drifted
    fits_j = jp._fit_spots(channels=["750", "647"], **FIT)
    fits_t = tp._fit_spots(channels=["750", "647"], **FIT)
    consts = {"750": np.zeros((3, 10), np.float32)}
    consts["750"][:, 0] = [0.1, -0.2, 0.3]
    for i, ch in enumerate(("750", "647")):
        g = _fits_match(fits_t[ch], fits_j[ch])
        corr_j = jp._correct_spot_coords(g[:, 1:4], ch, consts)
        corr_t = tp._correct_spot_coords(g[:, 1:4], ch, consts)
        np.testing.assert_allclose(corr_t.numpy(), corr_j, atol=1e-4)
        plain = tp._correct_spot_coords(g[:, 1:4], ch).numpy()
        assert _matched(plain, truth[i], 0.3) == len(truth[i])


def test_warp_then_fit_matches_jax(drifted):
    """The image path: the chromatic + drift warp of each channel, then the
    fits, against JAX's on the same steps; a warped channel is not warped
    twice."""
    jp, tp, _, _, truth = drifted
    consts = {"750": np.zeros((3, 10), np.float32)}
    consts["750"][:, 0] = [0.1, -0.2, 0.3]
    consts["750"][1, 2] = 4e-3
    jp._warp_image(channels=["750", "647"], chromatic_constants=consts)
    tp._warp_image(channels=["750", "647"], chromatic_constants=consts)
    for ch in ("750", "647"):
        _close(tp.ims[ch], jp.ims[ch])
        assert tp.correction_log[ch]["warp"]
    before = tp.ims["647"]
    tp._warp_image(channels=["647"])
    assert tp.ims["647"] is before
    fits_j = jp._fit_spots(channels=["647"], **FIT)
    fits_t = tp._fit_spots(channels=["647"], **FIT)
    g = _fits_match(fits_t["647"], fits_j["647"])
    assert _matched(g[:, 1:4], truth[1], 0.3) == len(truth[1])


def test_batch_process_image_quick_matches_jax(movies, tmp_path):
    path = movies[0][0]
    corr = str(tmp_path / "corrections")
    save_correction_profile(
        "illumination", {"750": jsyn.illumination_profile(SHAPE[1:], 0.5)},
        corr, corr_channels=["750"], im_size=SHAPE)
    kw = dict(all_channels=CHANNELS, single_im_size=SHAPE,
              num_buffer_frames=BUF)
    want = jdp.batch_process_image_quick(path, corr, ["750", "647"], **kw)
    got = tdp.batch_process_image_quick(path, corr, ["750", "647"],
                                        device="cpu", **kw)
    assert set(got) == set(want) == {"750", "647"}
    for ch in got:
        _close(got[ch], want[ch])
    raw = tdp.batch_process_image_quick(path, None, ["750"], device="cpu",
                                        corr_hot_pixels=False, **kw)
    np.testing.assert_array_equal(
        raw["750"].numpy(), load_dax_channels(path, ["750"], CHANNELS,
                                              n_z=SHAPE[0],
                                              buffer_frames=BUF)[0])


@pytest.fixture(scope="module")
def pipelines(movies):
    """Both packages' FovPipeline on the movies' geometry (exact
    classifier), the port's carried across from the JAX one's arrays, and
    the reference spectra of H0."""
    paths, _ = movies
    cfg = ExperimentConfig(image_size=SHAPE,
                           seed=SeedConfig(th_seed=400.0, max_num_seeds=32,
                                           pyramid_bg=False),
                           fit=FitConfig())
    chrom = np.zeros((3, 3, 10), np.float32)
    chrom[0, :, 0] = [0.1, -0.2, 0.15]
    jp = JaxPipeline(cfg, n_channels=3, drift_channel_index=2,
                     fit_channel_indices=(0, 1), chromatic_constants=chrom,
                     image_shape=SHAPE)
    h0 = load_dax_channels(paths[0], CHANNELS, CHANNELS, n_z=SHAPE[0],
                           buffer_frames=BUF)
    ref = jp.prepare_reference(jp.correct_reference(jnp.asarray(h0)))
    arrays = {"image_shape": np.asarray(SHAPE),
              "drift_idx": np.asarray(jp.drift_idx),
              "fit_idx": np.asarray(jp.fit_idx),
              "chromatic": np.asarray(jp.chromatic),
              "chrom_center": np.asarray(jp.chrom_center),
              "seed_thresholds": np.asarray(jp.seed_thresholds),
              "crops": np.asarray(jp.crops),
              "ref_spectra": np.asarray(ref)}
    tp, t_ref = pipeline_from_arrays(dataclasses.asdict(cfg), arrays,
                                     device="cpu")
    return jp, ref, tp, t_ref, paths


def _rounds_match(got, want):
    np.testing.assert_allclose(got.drift.numpy(), np.asarray(want.drift),
                               atol=0.0100001)
    np.testing.assert_array_equal(got.drift_flag.numpy(),
                                  np.asarray(want.drift_flag))
    vj = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), vj)
    assert vj.sum() >= 20
    for name in ("spots", "raw_spots"):
        g = getattr(got, name).numpy()[vj]
        w = np.asarray(getattr(want, name))[vj]
        np.testing.assert_allclose(g[:, 1:4], w[:, 1:4], atol=1e-3)
        np.testing.assert_allclose(g[:, 0], w[:, 0], rtol=1e-2)
        np.testing.assert_allclose(g[:, 5:8], w[:, 5:8], atol=1e-3)


def test_process_round_raw_matches_jax_and_process_round(pipelines):
    """The raw frame window, de-interleaved on the device: JAX's
    process_round_raw, and bit for bit the port's process_round on the
    loader's channels."""
    jp, ref, tp, t_ref, paths = pipelines
    win = tdax.raw_frame_window(CHANNELS, CHANNELS, n_z=SHAPE[0],
                                buffer_frames=BUF)
    raw = tdax.read_raw_window(paths[1], win)
    want = jp.process_round_raw(jnp.asarray(raw), ref, win.rel_starts,
                                win.n_colors, donate=False)
    got = tp.process_round_raw(raw, t_ref, win.rel_starts, win.n_colors)
    _rounds_match(got, want)
    np.testing.assert_allclose(got.drift.numpy(), -DRIFT, atol=0.1)
    block = load_dax_channels(paths[1], CHANNELS, CHANNELS, n_z=SHAPE[0],
                              buffer_frames=BUF)
    direct = tp.process_round(torch.from_numpy(block), t_ref)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(direct, f)), f


def test_process_rounds_matches_jax_and_single_rounds(pipelines):
    jp, ref, tp, t_ref, paths = pipelines
    ims = np.stack([load_dax_channels(p, CHANNELS, CHANNELS, n_z=SHAPE[0],
                                      buffer_frames=BUF) for p in paths])
    got = tp.process_rounds(ims, t_ref)
    want = jp.process_rounds(jnp.asarray(ims), ref)
    assert got.spots.shape[0] == 2 and got.drift.shape == (2, 3)
    for r in range(2):
        _rounds_match(type(got)(*(f[r] for f in got)),
                      type(want)(*(f[r] for f in want)))
        one = tp.process_round(torch.from_numpy(ims[r]), t_ref)
        for f in got._fields:
            assert torch.equal(getattr(got, f)[r], getattr(one, f)), f
    # the mesh form on a one-rank gloo group made here: the same rounds
    import torch.distributed as dist
    from imageanalysis3_tpu_torch.parallel import make_mesh
    mesh = make_mesh(device_type="cpu", store=dist.HashStore(), rank=0,
                     world_size=1)
    try:
        on_mesh = tp.process_rounds(ims, t_ref, mesh=mesh)
    finally:
        dist.destroy_process_group()
    for f in got._fields:
        assert torch.equal(getattr(on_mesh, f), getattr(got, f)), f


def test_dax_processer_defaults_to_cuda(movies, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdp.DaxProcesser(movies[0][0], all_channels=CHANNELS,
                         single_im_size=SHAPE, num_buffer_frames=BUF)
    assert os.path.exists(movies[0][0])
