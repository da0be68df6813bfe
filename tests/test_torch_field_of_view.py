"""PyTorch port vs JAX package: ``FieldOfView`` on one written experiment
(``write_synthetic_experiment``, (12, 128, 128), as
tests/test_field_of_view.py writes it), and the distance maps.

The port's facade reads a copy of the JAX facade's store, so both pick
from one candidate table: candidates and drifts equal, EM and naive
traces equal, scores rtol 2e-4, distance maps to 1e-5.  A port facade on
its own save folder processes the same regions with the same spot
counts.  Distance maps of seeded traces agree to 1e-5; their median over
an even count of cells averages the middle two."""

import shutil

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import imageanalysis3_tpu.config as jcfg
from imageanalysis3_tpu import synthetic as jsyn
from imageanalysis3_tpu.analysis import distmap as jd
from imageanalysis3_tpu.pipeline import FieldOfView as JaxFieldOfView
import imageanalysis3_tpu_torch.config as tcfg
from imageanalysis3_tpu_torch.analysis import distmap as td
from imageanalysis3_tpu_torch.pipeline import FieldOfView

torch.set_num_threads(2)
SHAPE = (12, 128, 128)
FOV = "Conv_zscan_00.dax"


def _cfg(m):
    return m.ExperimentConfig(
        image_size=SHAPE,
        correction=m.CorrectionConfig(illumination=False, hot_pixel=False),
        drift=m.DriftConfig(drift_size=64),
        seed=m.SeedConfig(th_seed=400.0, max_num_seeds=64, cand_capacity=512),
        fit=m.FitConfig(n_max_iter=4, lm_iters=20),
        num_buffer_frames=4)


@pytest.fixture(scope="module")
def jax_fov(tmp_path_factory):
    """(experiment root, the JAX facade after processing its FOV)."""
    root = tmp_path_factory.mktemp("exp_fov")
    jsyn.write_synthetic_experiment(
        str(root), shape=SHAPE, n_rounds=3, n_spots=10, seed=2,
        buffer_frames=4, channels=("750", "647", "488"))
    fov = JaxFieldOfView(str(root), str(root / "save_jax"), FOV,
                         cfg=_cfg(jcfg))
    assert fov.process_image_to_spots() == {"unique": 6}
    return root, fov


def _port_fov(root, save):
    return FieldOfView(str(root), str(save), FOV, cfg=_cfg(tcfg),
                       store_backend="h5py", device="cpu")


@pytest.fixture(scope="module")
def port_on_jax_store(jax_fov):
    root, _ = jax_fov
    shutil.copytree(root / "save_jax", root / "save_copy")
    return _port_fov(root, root / "save_copy")


def test_field_of_view_reads_the_jax_store(jax_fov, port_on_jax_store):
    """Nothing left to process; the same candidates and drifts."""
    _, jfov = jax_fov
    fov = port_on_jax_store
    assert fov.process_image_to_spots() == {"unique": 0}
    got, want = fov.load_candidate_spots(), jfov.load_candidate_spots()
    assert list(got) == list(want) and len(got) == 6
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    for a, b in zip(fov.drifts(), jfov.drifts()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(fov.candidate_table(capacity=8),
                    jfov.candidate_table(capacity=8)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method,center", [("EM", False), ("EM", True),
                                           ("naive", False),
                                           ("naive", True)])
def test_field_of_view_picks_and_maps_match_jax(jax_fov, port_on_jax_store,
                                                method, center):
    _, jfov = jax_fov
    fov = port_on_jax_store
    kw = {"num_iters": 5} if method == "EM" else {}
    ctr = None
    if center:
        cand, valid, _ = jfov.candidate_table()
        ctr = cand[..., 1:4][valid].mean(0).astype(np.float32)
    res_j = jfov.pick_spots(method=method, chrom_center=ctr, **kw)
    res_t = fov.pick_spots(method=method, chrom_center=ctr, device="cpu",
                           **kw)
    for name in ("sel_idx", "sel_valid", "trace", "n_iters",
                 "change_ratio"):
        np.testing.assert_array_equal(getattr(res_t, name).numpy(),
                                      np.asarray(getattr(res_j, name)),
                                      err_msg=name)
    assert res_t.n_iters.dtype == torch.int32
    np.testing.assert_allclose(res_t.scores.numpy(), np.asarray(res_j.scores),
                               rtol=2e-4, atol=1e-5)
    assert res_t.sel_valid.numpy().sum() >= 5
    dm_t = fov.distance_map(res_t.trace, device="cpu")
    dm_j = jfov.distance_map(np.asarray(res_j.trace))
    assert isinstance(dm_t, np.ndarray) and dm_t.shape == (6, 6)
    np.testing.assert_allclose(dm_t, dm_j, rtol=1e-5, atol=1e-5)


def test_field_of_view_processes_its_own_folder(jax_fov, tmp_path):
    """From an empty save folder: the JAX facade's regions, spot counts and
    drift flags, then a resume no-op."""
    root, jfov = jax_fov
    fov = _port_fov(root, tmp_path / "save_port")
    assert fov.process_image_to_spots() == {"unique": 6}
    assert fov.process_image_to_spots() == {"unique": 0}
    got, want = fov.load_candidate_spots(), jfov.load_candidate_spots()
    assert {k: len(v) for k, v in got.items()} == \
        {k: len(v) for k, v in want.items()}
    np.testing.assert_array_equal(fov.drifts()[1], jfov.drifts()[1])
    res = fov.pick_spots(method="EM", num_iters=5, device="cpu")
    assert res.sel_valid.numpy().sum() >= 5


def test_field_of_view_needs_a_card_without_device(jax_fov, tmp_path,
                                                   monkeypatch):
    """The driver runs on the CPU here, but picks and maps asked for with
    no `device` go to the card, and there is none."""
    root, _ = jax_fov
    shutil.copytree(root / "save_jax", tmp_path / "save")
    fov = _port_fov(root, tmp_path / "save")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for method in ("EM", "naive"):
        with pytest.raises(RuntimeError, match="CUDA"):
            fov.pick_spots(method=method)
    res = fov.pick_spots(method="naive", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        fov.distance_map(res.trace.numpy())


def _traces(seed, b=6, n=9):
    rng = np.random.default_rng(seed)
    z = np.cumsum(rng.normal(0, 150, (b, n, 3)), axis=1).astype(np.float32)
    z[rng.uniform(size=(b, n)) < 0.2] = np.nan
    return z


@pytest.mark.parametrize("seed,b", [(0, 6), (1, 7)])
def test_distance_maps_match_jax(seed, b):
    """Maps of traces with missing regions; the median over an even count
    of finite entries averages the middle two, as JAX's does."""
    z = _traces(seed, b)
    spots = np.zeros(z.shape[:2] + (11,), np.float32)
    spots[..., 1:4] = z / np.asarray([200.0, 108.0, 108.0], np.float32)
    np.testing.assert_allclose(
        td.spots_to_zxy_nm(torch.from_numpy(spots)).numpy(),
        np.asarray(jd.spots_to_zxy_nm(jnp.asarray(spots))), rtol=1e-6)
    np.testing.assert_allclose(td.distance_map(torch.from_numpy(z[0])),
                               np.asarray(jd.distance_map(jnp.asarray(z[0]))),
                               rtol=1e-5, atol=1e-5)
    med_t = td.median_distance_map(torch.from_numpy(z)).numpy()
    med_j = np.asarray(jd.median_distance_map(jnp.asarray(z)))
    np.testing.assert_allclose(med_t, med_j, rtol=1e-5, atol=1e-5)
    with np.errstate(invalid="ignore"):
        want = np.nanmedian(np.linalg.norm(
            z[:, :, None].astype(np.float64) - z[:, None], axis=-1), axis=0)
    np.testing.assert_allclose(med_t, want, rtol=1e-5, atol=1e-4)
    for th in (200.0, 500.0):
        np.testing.assert_allclose(
            td.contact_map(torch.from_numpy(z), th).numpy(),
            np.asarray(jd.contact_map(jnp.asarray(z), th)), rtol=1e-6)
