"""PyTorch port vs JAX package: ``ExperimentDriver`` on the same written
experiment folders (``write_synthetic_experiment``: hyb folders of .dax
movies and a Color_Usage.csv).

The JAX driver is the reference; both write h5py stores, compared row by
row.  Tolerances are tests/test_torch_dax_processer.py's: drifts within
one upsample step (0.0100001 px) with equal flags (on noisy crops one crop
of eight can land one grid step apart between the two FFT libraries);
equal ``n_spots`` and valid rows; centres (the raw fits, and the
corrected ones less each package's own drift) and widths within 1e-3 px,
heights rtol 1e-2; images rtol 1e-5, atol 1e-2.  Steps that read stored
drifts (crops) run the port on a copy of the JAX store, so they start
from JAX's drifts.  The port's own runs (input modes, backends, resume)
are held to each other exactly."""

import hashlib
import os
import shutil

import numpy as np
import pytest
import torch

import imageanalysis3_tpu.config as jcfg
from imageanalysis3_tpu import synthetic as jsyn
from imageanalysis3_tpu.io.store import FovStore as JaxStore
from imageanalysis3_tpu.pipeline import experiment as jexp
import imageanalysis3_tpu_torch.config as tcfg
from imageanalysis3_tpu_torch.io import (load_dax_channels,
                                         save_correction_profile)
from imageanalysis3_tpu_torch.io.store import FovStore
from imageanalysis3_tpu_torch.pipeline import experiment as texp

torch.set_num_threads(2)
SHAPE = (12, 128, 128)
FOV = "Conv_zscan_00.dax"
CHANNELS = ("750", "647", "488")


def _cfg(m, **correction):
    corr = {"illumination": False, "hot_pixel": False, **correction}
    return m.ExperimentConfig(
        image_size=SHAPE, corr_channels=("750", "647"),
        correction=m.CorrectionConfig(**corr),
        drift=m.DriftConfig(drift_size=64),
        seed=m.SeedConfig(th_seed=400.0, max_num_seeds=64, cand_capacity=512),
        fit=m.FitConfig(n_max_iter=4, lm_iters=20),
        num_buffer_frames=4)


def _drivers(root, save, correction=None, **kw):
    """(JAX driver, port driver) on `root`, saving under save/jax and
    save/port (h5py stores both)."""
    correction = correction or {}
    j = jexp.ExperimentDriver(str(root), str(save / "jax"),
                              cfg=_cfg(jcfg, **correction), **kw)
    t = texp.ExperimentDriver(str(root), str(save / "port"),
                              cfg=_cfg(tcfg, **correction), device="cpu",
                              store_backend="h5py", **kw)
    return j, t


def _rows(path, reader=FovStore):
    with reader(path, "r") as s:
        g = s._fh["unique"]
        return {k: g[k][:] for k in g.keys()}


def _stores_match(port_path, jax_path):
    got, want = _rows(port_path), _rows(jax_path, JaxStore)
    assert set(got) == set(want)
    for k in ("ids", "channels", "flags", "drift_flags", "n_spots"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["drifts"], want["drifts"], atol=0.0100001)
    for i, n in enumerate(want["n_spots"]):
        assert n >= 5
        for name, less in (("raw_spots", 0), ("spots", 1)):
            g = got[name][i].copy()
            w = want[name][i].copy()
            assert np.isfinite(g[:n]).all() and np.isnan(g[n:]).all()
            g[:, 1:4] -= less * got["drifts"][i]
            w[:, 1:4] -= less * want["drifts"][i]
            np.testing.assert_allclose(g[:n, 1:4], w[:n, 1:4], atol=1e-3)
            np.testing.assert_allclose(g[:n, 0], w[:n, 0], rtol=1e-2)
            np.testing.assert_allclose(g[:n, 5:8], w[:n, 5:8], atol=1e-3)


def _assert_rows_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _hashes(folder):
    out = {}
    for d, _, files in os.walk(folder):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), folder)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return out


def _rounds_run(drv, stage="process_round"):
    return [r["folder"] for r in drv.timings.records if r["stage"] == stage]


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    root = tmp_path_factory.mktemp("exp")
    truth = jsyn.write_synthetic_experiment(
        str(root), shape=SHAPE, n_rounds=3, n_spots=10, seed=1,
        buffer_frames=4, channels=CHANNELS)
    return root, truth


@pytest.fixture(scope="module")
def default_runs(experiment, tmp_path_factory):
    root, _ = experiment
    save = tmp_path_factory.mktemp("save_default")
    j, t = _drivers(root, save)
    assert j.process_fov(FOV) == t.process_fov(FOV) == {"unique": 6}
    return j, t


def test_region_table_and_parse_region_entry(experiment):
    for info in ("u101", "c5", "m12", "d3", "v7", "l2", "r4", "g9", "p1",
                 "beads", "DAPI", "", "u1_chrom", "ux", "z4", "U12"):
        assert texp.parse_region_entry(info) == jexp.parse_region_entry(info)
    assert texp.DATA_TYPE_PREFIXES == jexp.DATA_TYPE_PREFIXES
    root, _ = experiment
    j = jexp.ExperimentDriver(str(root), str(root / "unused_j"),
                              cfg=_cfg(jcfg))
    t = texp.ExperimentDriver(str(root), str(root / "unused_t"),
                              cfg=_cfg(tcfg), device="cpu")
    assert t.region_table() == j.region_table()
    assert len(t.region_table()["unique"]) == 6
    assert [vars(p) for p in t._plans] == [vars(p) for p in j._plans]
    assert (t.folders, t.fovs, t.ref_folder) == (j.folders, j.fovs,
                                                 j.ref_folder)
    assert t.store_path(FOV).endswith("Conv_zscan_00.hdf5")


def test_driver_defaults_to_cuda(experiment, monkeypatch):
    root, _ = experiment
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        texp.ExperimentDriver(str(root), str(root / "unused_t"),
                              cfg=_cfg(tcfg))


def test_default_mode_matches_jax(default_runs, experiment):
    j, t = default_runs
    _stores_match(t.store_path(FOV), j.store_path(FOV))
    summary = t.timings.summary()
    for stage in ("store_open", "load_dax", "correct_reference",
                  "process_round", "save", "save_drain"):
        assert stage in summary, stage
    assert [r["backend"] for r in t.timings.records
            if r["stage"] == "store_open"] == ["h5py"]
    assert _rounds_run(t) == _rounds_run(j)
    # drift against the planted displacement, as tests/test_experiment.py
    _, truth = experiment
    with FovStore(t.store_path(FOV), "r") as s:
        for rid, info in truth["regions"].items():
            drift = s.drifts("unique")[s.region_index("unique", rid)]
            np.testing.assert_allclose(drift, -truth["drifts"][info["round"]],
                                       atol=0.5)


def test_npy_backend_resume_and_partial_resume(default_runs, experiment,
                                               tmp_path):
    """The NumPy store holds what the h5py one does; a rerun is a no-op
    that leaves every file byte-identical; a region set back to flag 0 is
    processed again, alone, in one round, into the same row."""
    _, t_h5 = default_runs
    root, truth = experiment
    t = texp.ExperimentDriver(str(root), str(tmp_path), cfg=_cfg(tcfg),
                              device="cpu", store_backend="npy")
    path = t.store_path(FOV)
    assert path.endswith("Conv_zscan_00.fovstore")
    assert t.process_fov(FOV) == {"unique": 6}
    first = _rows(path)
    _assert_rows_equal(first, _rows(t_h5.store_path(FOV)))
    before = _hashes(path)
    assert t.process_all() == {FOV: {"unique": 0}}
    assert _hashes(path) == before
    rid = 4
    with FovStore(path) as s:
        s.set_flag("unique", rid, 0)
        row = s.region_index("unique", rid)
    t2 = texp.ExperimentDriver(str(root), str(tmp_path), cfg=_cfg(tcfg),
                               device="cpu", store_backend="npy")
    assert t2.process_fov(FOV) == {"unique": 1}
    r = truth["regions"][rid]["round"]
    assert _rounds_run(t2) == [f"H{r}R{r}"]
    _assert_rows_equal(_rows(path), first)


def test_device_deinterleave_matches_default(default_runs, experiment,
                                             tmp_path):
    j, t = default_runs
    root, _ = experiment
    raw = texp.ExperimentDriver(str(root), str(tmp_path), cfg=_cfg(tcfg),
                                device="cpu", store_backend="h5py",
                                device_deinterleave=True)
    assert raw.process_fov(FOV) == {"unique": 6}
    _assert_rows_equal(_rows(raw.store_path(FOV)), _rows(t.store_path(FOV)))
    _stores_match(raw.store_path(FOV), j.store_path(FOV))


def test_sequential_drift_and_partial_resume(experiment, tmp_path):
    root, truth = experiment
    j, t = _drivers(root, tmp_path, sequential_drift=True)
    assert j.process_fov(FOV) == t.process_fov(FOV) == {"unique": 6}
    _stores_match(t.store_path(FOV), j.store_path(FOV))
    first = _rows(t.store_path(FOV))
    last = max(info["round"] for info in truth["regions"].values())
    rid = next(r for r, info in truth["regions"].items()
               if info["round"] == last)
    with FovStore(t.store_path(FOV)) as s:
        s.set_flag("unique", rid, 0)
    t2 = texp.ExperimentDriver(str(root), str(tmp_path / "port"),
                               cfg=_cfg(tcfg), device="cpu",
                               store_backend="h5py", sequential_drift=True)
    assert t2.process_fov(FOV) == {"unique": 1}
    assert set(_rounds_run(t2, "load_dax")) == {f"H{last - 1}R{last - 1}",
                                                f"H{last}R{last}"}
    _assert_rows_equal(_rows(t.store_path(FOV)), first)


def _planted_chromatic():
    """tests/test_distorted_experiment.py's order-2 field on '750'."""
    c = np.zeros((3, 10), np.float32)
    c[0, 0], c[1, 0], c[1, 2], c[2, 0], c[2, 3] = 0.2, 0.3, 0.004, -0.25, \
        0.003
    return c


@pytest.fixture(scope="module")
def corrected_runs(tmp_path_factory):
    """The distorted scene (vignette, bleed, chromatic shifts) with its
    planted profiles in a correction folder, read by both drivers."""
    root = tmp_path_factory.mktemp("exp_distorted")
    truth = jsyn.write_synthetic_experiment(
        str(root), shape=SHAPE, n_rounds=3, n_spots=10, seed=7,
        buffer_frames=4, channels=CHANNELS, illumination_falloff=0.35,
        bleed_leak=0.08, chromatic_constants={"750": _planted_chromatic()},
        corr_channels=("750", "647"))
    folder = str(root / "Corrections")
    corr = ("750", "647")
    save_correction_profile(
        "illumination", {c: truth["illumination"][c].astype(np.float32)
                         for c in corr}, folder, corr, im_size=SHAPE)
    unmix = np.linalg.inv(truth["bleed_matrix"]).astype(np.float32)
    save_correction_profile(
        "bleedthrough", np.broadcast_to(unmix[:, :, None, None],
                                        (2, 2) + SHAPE[1:]),
        folder, corr, im_size=SHAPE)
    save_correction_profile(
        "chromatic_constants", {"750": _planted_chromatic(), "647": None},
        folder, corr, im_size=SHAPE)
    save = tmp_path_factory.mktemp("save_distorted")
    j, t = _drivers(root, save, correction=dict(illumination=True,
                                                bleedthrough=True),
                    correction_folder=folder)
    assert j.process_fov(FOV) == t.process_fov(FOV) == {"unique": 6}
    return j, t, truth


def test_correction_folder_chain_matches_jax(corrected_runs):
    j, t, truth = corrected_runs
    assert set(t.illumination_profiles) == set(j.illumination_profiles) \
        == {"750", "647"}
    np.testing.assert_array_equal(t.bleed_profile, j.bleed_profile)
    np.testing.assert_array_equal(t.chromatic_constants["750"],
                                  j.chromatic_constants["750"])
    _stores_match(t.store_path(FOV), j.store_path(FOV))
    # the planted optics are undone: spots land on the round-0 truth
    with FovStore(t.store_path(FOV), "r") as s:
        for rid, info in truth["regions"].items():
            got = s.load_spots("unique", rid)[0][:, 1:4]
            d = np.linalg.norm(got[None] - info["centers"][:, None],
                               axis=-1).min(axis=1)
            assert (d < 0.5).mean() >= 0.8


def test_load_region_crops_matches_jax(corrected_runs):
    """Crops from disk, flat-fielded and resampled by the stored drift:
    the port reads a copy of the JAX store, so both start from one drift;
    H0's regions (drift 0) are the window over the profile, exactly."""
    j, t, truth = corrected_runs
    shutil.copy(j.store_path(FOV), t.store_path(FOV))
    lims = [[2, 10], [30, 90], [24, 100]]
    got = t.load_region_crops(FOV, lims, "unique")
    want = j.load_region_crops(FOV, lims, "unique")
    assert sorted(got) == sorted(want) and len(got) == 6
    for rid in want:
        assert got[rid].shape == (8, 60, 76) and got[rid].dtype == np.float32
        np.testing.assert_allclose(got[rid], want[rid], rtol=1e-5, atol=1e-2)
    block = load_dax_channels(os.path.join(truth["folders"][0], FOV),
                              list(CHANNELS), list(CHANNELS), n_z=SHAPE[0],
                              buffer_frames=4)
    for ci, rid in enumerate((1, 2)):
        prof = t.illumination_profiles[CHANNELS[ci]][30:90, 24:100]
        np.testing.assert_array_equal(
            got[rid], block[ci, 2:10, 30:90, 24:100].astype(np.float32)
            / prof[None])
    sub = t.load_region_crops(FOV, [[30, 90], [24, 100]], "unique",
                              region_ids=[3], correct_illumination=False)
    want_sub = j.load_region_crops(FOV, [[30, 90], [24, 100]], "unique",
                                   region_ids=[3],
                                   correct_illumination=False)
    assert list(sub) == [3] and sub[3].shape == (12, 60, 76)
    np.testing.assert_allclose(sub[3], want_sub[3], rtol=1e-5, atol=1e-2)


def test_load_dapi_image_matches_jax(tmp_path):
    """A round whose 647 channel is DAPI-marked: corrected, aligned to the
    reference round, cached in the store's signal group."""
    root = tmp_path / "exp_dapi"
    jsyn.write_synthetic_experiment(str(root), shape=SHAPE, n_rounds=2,
                                    n_spots=8, seed=5, buffer_frames=4,
                                    channels=CHANNELS)
    path = root / "Color_Usage.csv"
    path.write_text(path.read_text().replace("u4", "DAPI"))
    j, t = _drivers(root, tmp_path)
    assert t._marker_plan("dapi")[0].channels == ["647", "488"]
    want = j.load_dapi_image(FOV)
    got = t.load_dapi_image(FOV)
    assert got.shape == SHAPE and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-2)
    with FovStore(t.store_path(FOV), "r") as s:
        np.testing.assert_array_equal(s.load_signal("dapi_im"), got)
    np.testing.assert_array_equal(t.load_dapi_image(FOV), got)
    no_dapi = texp.ExperimentDriver(str(root), str(tmp_path / "x"),
                                    cfg=_cfg(tcfg), device="cpu")
    path.write_text(path.read_text().replace("DAPI", "u4"))
    no_dapi.color_usage = texp.load_color_usage(str(root))
    with pytest.raises(ValueError, match="DAPI"):
        no_dapi.load_dapi_image(FOV)
