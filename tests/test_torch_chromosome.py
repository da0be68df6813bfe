"""PyTorch port vs JAX package: chromosome candidates
(``segmentation.chromosome``) and the driver's chromosome steps.

``assign_seeds_to_nuclei`` and ``select_candidate_chromosomes`` must agree
exactly (the same labels; the same kept mask, ties to the first minimum
and the all-lost case included); ``find_candidate_chromosomes`` must give
the same candidate set, labels and counts.  At the default background
sigma (10, radius 40) both packages' ``get_seeds`` take their plain
classifier.  The driver's ``generate_chromosome_image`` is held at images'
tolerance (rtol 1e-5, atol 1e-2) on one processed experiment whose store
both drivers read (JAX wrote it), then ``identify_chromosomes`` and
``select_chromosomes_by_spots`` must return the same coordinates."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imageanalysis3_tpu.config as jcfg
from imageanalysis3_tpu import synthetic as jsyn
from imageanalysis3_tpu.io.store import FovStore as JaxStore
from imageanalysis3_tpu.pipeline import experiment as jexp
from imageanalysis3_tpu.segmentation import chromosome as jchr
import imageanalysis3_tpu_torch.config as tcfg
from imageanalysis3_tpu_torch.io.store import FovStore
from imageanalysis3_tpu_torch.pipeline import experiment as texp
from imageanalysis3_tpu_torch.segmentation import chromosome as tchr

torch.set_num_threads(2)
SHAPE = (12, 128, 128)
FOV = "Conv_zscan_00.dax"


def _boxes():
    """Two box nuclei: labels 1 and 2 on the two halves of the FOV."""
    labels = np.zeros(SHAPE, np.int32)
    labels[:, 4:62, 4:124] = 1
    labels[:, 66:124, 4:124] = 2
    return labels


def test_assign_seeds_to_nuclei_matches_jax():
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 4, size=SHAPE).astype(np.int32)
    coords = np.concatenate([
        rng.integers(0, 128, size=(40, 3)),
        [[-1, -1, -1], [20, 200, -5], [11, 127, 127]]]).astype(np.int32)
    valid = rng.random(len(coords)) > 0.2
    valid[-3:] = [False, True, True]
    got = tchr.assign_seeds_to_nuclei(torch.from_numpy(labels),
                                      torch.from_numpy(coords),
                                      torch.from_numpy(valid))
    want = jchr.assign_seeds_to_nuclei(jnp.asarray(labels),
                                       jnp.asarray(coords),
                                       jnp.asarray(valid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def chrom_scene():
    rng = np.random.default_rng(3)
    t = jsyn.sample_spot_params(SHAPE, 16, rng, min_separation=12.0,
                                height_range=(800.0, 4000.0))
    im = jsyn.render_gaussian_spots(SHAPE, t["centers"], t["heights"],
                                    t["sigmas"], 150.0)
    return jsyn.poisson_camera_noise(im, rng).astype(np.float32)


@pytest.mark.parametrize("expected, min_sep", [(2, 3.0), (5, 0.0)])
def test_find_candidate_chromosomes_matches_jax(chrom_scene, expected,
                                                min_sep):
    th = float(3.0 * np.std(chrom_scene))
    kw = dict(expected_per_nucleus=expected, th_seed=th,
              min_separation=min_sep, max_candidates=256)
    got = tchr.find_candidate_chromosomes(chrom_scene, _boxes(),
                                          device="cpu", **kw)
    want = jchr.find_candidate_chromosomes(jnp.asarray(chrom_scene),
                                           jnp.asarray(_boxes()), **kw)
    assert len(got[0]) == len(want[0]) > 0
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    assert got[2] == want[2]
    assert set(got[2]) == {1, 2}
    assert max(got[2].values()) <= expected


def _spots_list(rng, cands, n_rounds, drop):
    """Per round: a spot at every candidate but those in `drop[r]`, with
    intensities in (0, 2), plus background spots."""
    out = []
    for r in range(n_rounds):
        keep = [c for k, c in enumerate(cands) if k not in drop[r]]
        pts = np.concatenate([np.asarray(keep).reshape(-1, 3)
                              + rng.normal(0, 0.5, (len(keep), 3)),
                              rng.uniform(0, 128, (6, 3))])
        s = np.zeros((len(pts), 11))
        s[:, 0] = rng.uniform(0.0, 2.0, len(pts))
        s[:, 1:4] = pts
        out.append(s)
    return out


@pytest.mark.parametrize("int_th, loss_th", [(0.2, 0.5), (0.5, 0.4),
                                             (1e9, 0.5), (0.0, 0.0)])
def test_select_candidate_chromosomes_matches_jax(int_th, loss_th):
    rng = np.random.default_rng(5)
    cands = rng.uniform(10, 118, (6, 3)).round(1)
    drop = [{0}, {0, 3}, {0}, set(), {5}]
    spots = _spots_list(rng, cands, 5, drop)
    spots.append(np.zeros((0, 11)))
    got = tchr.select_candidate_chromosomes(
        cands, spots, cand_spot_intensity_th=int_th,
        good_chr_loss_th=loss_th, device="cpu")
    want = jchr.select_candidate_chromosomes(
        cands, spots, cand_spot_intensity_th=int_th,
        good_chr_loss_th=loss_th)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    if int_th == 1e9:
        assert not got[1].any()


def test_select_candidate_chromosomes_ties_and_edges():
    # a spot equidistant to candidates 0 and 1 goes to the first
    cands = np.array([[5.0, 10.0, 10.0], [5.0, 10.0, 14.0],
                      [5.0, 60.0, 60.0]])
    mid = np.zeros((1, 11))
    mid[0, :4] = [1.0, 5.0, 10.0, 12.0]
    for spots in ([mid, mid], [mid, np.zeros((0, 11))], []):
        got = tchr.select_candidate_chromosomes(cands, spots, 0.5, 0.4,
                                                device="cpu")
        want = jchr.select_candidate_chromosomes(cands, spots, 0.5, 0.4)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
    assert tchr.select_candidate_chromosomes(np.zeros((0, 3)), [mid],
                                             device="cpu")[1].shape == (0,)


def _cfg(m):
    return m.ExperimentConfig(
        image_size=SHAPE,
        correction=m.CorrectionConfig(illumination=False, hot_pixel=False),
        drift=m.DriftConfig(drift_size=64),
        seed=m.SeedConfig(th_seed=400.0, max_num_seeds=64, cand_capacity=512),
        fit=m.FitConfig(n_max_iter=4, lm_iters=20), num_buffer_frames=4)


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    """One experiment processed by the JAX driver; the port's driver reads
    a copy of its store.  Both stores get the two box nuclei."""
    root = tmp_path_factory.mktemp("exp_chrom")
    truth = jsyn.write_synthetic_experiment(
        str(root), shape=SHAPE, n_rounds=3, n_spots=10, seed=7,
        buffer_frames=4, channels=("750", "647", "488"))
    save = tmp_path_factory.mktemp("save_chrom")
    j = jexp.ExperimentDriver(str(root), str(save / "jax"), cfg=_cfg(jcfg))
    t = texp.ExperimentDriver(str(root), str(save / "port"), cfg=_cfg(tcfg),
                              device="cpu", store_backend="h5py")
    assert j.process_fov(FOV) == {"unique": 6}
    shutil.copy(j.store_path(FOV), t.store_path(FOV))
    for d, store in ((j, JaxStore), (t, FovStore)):
        with store(d.store_path(FOV)) as s:
            s.save_segmentation(_boxes())
    return j, t, truth


def test_driver_chromosome_steps_match_jax(processed):
    j, t, truth = processed
    want = j.generate_chromosome_image(FOV)
    got = t.generate_chromosome_image(FOV)
    assert got.shape == SHAPE and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-2)
    bg = np.median(got)
    for info in truth["regions"].values():
        for c in info["centers"]:
            zi, xi, yi = np.round(c).astype(int)
            assert got[zi, xi, yi] > 1.5 * bg
    # cached in the store's signal group
    np.testing.assert_array_equal(t.generate_chromosome_image(FOV), got)
    with FovStore(t.store_path(FOV), "r") as s:
        np.testing.assert_array_equal(s.load_signal("chrom_im"), got)

    coords, labels, counts = t.identify_chromosomes(FOV,
                                                    expected_per_nucleus=4)
    w_coords, w_labels, w_counts = j.identify_chromosomes(
        FOV, expected_per_nucleus=4)
    np.testing.assert_array_equal(coords, np.asarray(w_coords))
    np.testing.assert_array_equal(labels, np.asarray(w_labels))
    assert counts == w_counts and set(labels) <= {1, 2} and len(coords)
    assert max(counts.values()) <= 4
    with FovStore(t.store_path(FOV), "r") as s:
        np.testing.assert_array_equal(s.load_signal("chrom_coords"), coords)
        np.testing.assert_array_equal(s.load_signal("chrom_labels"), labels)

    kept = t.select_chromosomes_by_spots(FOV, cand_spot_intensity_th=0.2,
                                         good_chr_loss_th=0.5)
    np.testing.assert_array_equal(
        kept, j.select_chromosomes_by_spots(FOV, cand_spot_intensity_th=0.2,
                                            good_chr_loss_th=0.5))
    none = t.select_chromosomes_by_spots(FOV, cand_spot_intensity_th=1e9,
                                         good_chr_loss_th=0.5, save=False)
    assert none.shape == (0, 3)
    with FovStore(t.store_path(FOV), "r") as s:
        np.testing.assert_array_equal(s.load_signal("chrom_coords"), kept)


def test_driver_chromosome_steps_need_their_inputs(processed, tmp_path):
    _, t, _ = processed
    empty = texp.ExperimentDriver(t.data_folder, str(tmp_path), cfg=t.cfg,
                                  device="cpu")
    with FovStore(empty.store_path(FOV)) as s:     # no region processed
        s.init_data_type("unique", [1, 2], ["750", "647"], 8)
    with pytest.raises(RuntimeError, match="process_fov"):
        empty.generate_chromosome_image(FOV)
    with pytest.raises(RuntimeError, match="identify_chromosomes"):
        empty.select_chromosomes_by_spots(FOV)
