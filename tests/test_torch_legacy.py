"""PyTorch port vs JAX package: the legacy Cell_List / Cell_Data facade
(reference classes/__init__.py:817-4513).

Every case of tests/test_legacy.py runs on the port (``device="cpu"``)
and against the JAX facade on the same inputs.  The driver cases share one
written experiment per scene (tests/test_legacy.py's size: 12x128x128, 2
rounds of 8 spots) and one JAX run of it (module fixtures); the port runs
each CellList case once with each store backend (``h5py`` and ``npy``):
its own ``_process_fovs`` into a store of that backend (held to JAX's at
tests/test_torch_experiment.py's tolerances), and the facade steps on a
copy of JAX's store in that backend, so they start from JAX's spots,
drifts and images and are held to JAX's exactly (fits at the fit
tolerances: centres and widths 1e-3 px, heights rtol 1e-2; EM scores rtol
2e-4 as tests/test_torch_picking.py).

Three faults of the JAX file are put right in the port, following
ImageAnalysis3 (ADVICE.md r5): ternary dependent-map flags, no FOV-extent
guess in ``_translate_chromosome_coords``, and its ``overwrite=True``
default.  One test per fault asserts the reference semantics; beside each
a parity case against JAX is marked ``xfail(strict=True)``, so it fails
loudly if the two ever agree.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import imageanalysis3_tpu.config as jcfg
from imageanalysis3_tpu import synthetic as jsyn
from imageanalysis3_tpu.io.store import FovStore as JaxStore
from imageanalysis3_tpu.legacy import CellData as JCell
from imageanalysis3_tpu.legacy import CellList as JList
import imageanalysis3_tpu_torch.config as tcfg
from imageanalysis3_tpu_torch import legacy as L
from imageanalysis3_tpu_torch.io.store import FovStore
from imageanalysis3_tpu_torch.legacy import CellData, CellList

torch.set_num_threads(2)
SHAPE = (12, 128, 128)
FOV = "Conv_zscan_00.dax"
CPU = torch.device("cpu")
BACKENDS = ("h5py", "npy")
HAZARD4 = ("ADVICE.md r5: the JAX facade keeps the reference fault this "
           "port puts right (hazard 4)")


def _cfg(m):
    return m.ExperimentConfig(
        image_size=SHAPE,
        correction=m.CorrectionConfig(illumination=False, hot_pixel=False),
        drift=m.DriftConfig(drift_size=64),
        seed=m.SeedConfig(th_seed=400.0, max_num_seeds=64, cand_capacity=512),
        fit=m.FitConfig(n_max_iter=3, lm_iters=15),
        num_buffer_frames=4)


def _cell(*args, **kw):
    return CellData(*args, device="cpu", **kw)


def _cand_spots(rng, n_regions=20):
    steps = rng.normal(0, 300 / np.sqrt(3), (n_regions, 3))
    zxys = np.array([2000.0, 5000, 5000]) + np.cumsum(steps, axis=0)
    out = {}
    for r in range(n_regions):
        rows = np.zeros((3, 11), np.float32)
        rows[0, 0] = rng.uniform(900, 1500)
        rows[0, 1:4] = (zxys[r] + rng.normal(0, 30, 3)) / [200, 108, 108]
        for d in (1, 2):
            rows[d, 0] = rng.uniform(600, 2000)
            rows[d, 1:4] = (zxys.mean(0)
                            + rng.normal(0, 4000, 3)) / [200, 108, 108]
        out[r] = rows
    return out, zxys


def _fake_lists(cells, jcells, save_folder=".", cfg=None, store_path=None):
    """(port, JAX) CellLists over fake drivers, as tests/test_legacy.py
    builds them."""

    class _FakeDriver:
        data_folder = "."
        fovs = []

    _FakeDriver.save_folder = save_folder
    if cfg is not None:
        _FakeDriver.cfg = cfg
    if store_path is not None:
        _FakeDriver.store_path = store_path
    cl = CellList.__new__(CellList)
    cl.driver, cl.device, cl.cells = _FakeDriver(), CPU, cells
    jl = JList.__new__(JList)
    jl.driver, jl.cells = _FakeDriver(), jcells
    return cl, jl


def _fits_agree(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a[:, 1:4], b[:, 1:4], atol=1e-3)
    np.testing.assert_allclose(a[:, 0], b[:, 0], rtol=1e-2)
    np.testing.assert_allclose(a[:, 5:8], b[:, 5:8], atol=1e-3)


def _same_traces(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# written experiments: one JAX run per scene, the port per store backend
# ---------------------------------------------------------------------------


def _transcribe(jax_path: str, path: str, backend: str) -> None:
    """Copy a JAX-written HDF5 store into a port store of `backend`
    through the port's public writes (the h5py backend copies the file)."""
    if backend == "h5py":
        shutil.copy(jax_path, path)
        return
    import h5py
    with h5py.File(jax_path, "r") as src, \
            FovStore(path, "a", backend=backend) as dst:
        dst.set_fov_info(**dict(src.attrs.items()))
        for dt in (k for k in src if k not in ("segmentation", "signal")):
            g = src[dt]
            ids = g["ids"][:]
            dst.init_data_type(dt, ids, [c.decode() for c in g["channels"]],
                               g["spots"].shape[1])
            for i, rid in enumerate(ids):
                n = int(g["n_spots"][i])
                if int(g["flags"][i]):
                    dst.save_spots(dt, int(rid), g["spots"][i, :n],
                                   g["raw_spots"][i, :n], g["drifts"][i],
                                   flag=int(g["flags"][i]),
                                   drift_flag=int(g["drift_flags"][i]))
                if "ims" in g:
                    dst.save_image(dt, int(rid), g["ims"][i])
        if "segmentation" in src:
            dst.save_segmentation(src["segmentation"]["labels"][:])
        for name in src.get("signal", {}):
            dst.save_signal(name, src["signal"][name][:])


def _halves():
    labels = np.zeros(SHAPE, np.int32)
    labels[:, :, :64] = 1
    labels[:, :, 64:] = 2
    return labels


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """tests/test_legacy.py's stored experiment (seed 7, corrected images
    saved), processed by the JAX facade once, with two y-half "cells"
    saved as its segmentation afterwards."""
    root = tmp_path_factory.mktemp("exp")
    jsyn.write_synthetic_experiment(str(root), shape=SHAPE, n_rounds=2,
                                    n_spots=8, seed=7, buffer_frames=4)
    save = tmp_path_factory.mktemp("save_jax")
    jl = JList(str(root), str(save), cfg=_cfg(jcfg), save_images=True)
    counts = jl._process_fovs()
    with JaxStore(jl.driver.store_path(FOV)) as store:
        store.save_segmentation(_halves())
    return root, save, counts


def _jax_list(scene):
    root, save, _ = scene
    return JList(str(root), str(save), cfg=_cfg(jcfg))


@pytest.fixture(scope="module", params=BACKENDS)
def port_runs(request, scene, tmp_path_factory):
    """The port per store backend: its own ``_process_fovs`` (store
    "own"), and a copy of JAX's store for the facade steps ("facade")."""
    backend = request.param
    root, jsave, _ = scene
    save = tmp_path_factory.mktemp(f"save_port_{backend}")
    own = CellList(str(root), str(save / "own"), cfg=_cfg(tcfg),
                   save_images=True, device="cpu", store_backend=backend)
    counts = own._process_fovs()
    facade = CellList(str(root), str(save / "facade"), cfg=_cfg(tcfg),
                      device="cpu", store_backend=backend)
    _transcribe(str(jsave / FOV.replace(".dax", ".hdf5")),
                facade.driver.store_path(FOV), backend)
    return backend, save, counts, own


def _facade(port_runs, scene):
    root, _, _ = scene
    backend, save, _, _ = port_runs
    return CellList(str(root), str(save / "facade"), cfg=_cfg(tcfg),
                    device="cpu", store_backend=backend)


def test_cell_list_process_fovs_matches_jax(port_runs, scene):
    """The port's own run: the same counts as JAX's, a store of the asked
    backend whose rows (tests/test_torch_experiment.py's tolerances) and
    corrected images (within one uint16 count) are JAX's."""
    backend, _, counts, own = port_runs
    _, jsave, jcounts = scene
    assert counts == jcounts == {FOV: {"unique": 4}}
    jpath = str(jsave / FOV.replace(".dax", ".hdf5"))
    with FovStore(own.driver.store_path(FOV), "r") as got, \
            JaxStore(jpath, "r") as want:
        assert got.backend == backend
        np.testing.assert_array_equal(got.ids("unique"),
                                      want._fh["unique"]["ids"][:])
        np.testing.assert_allclose(got.drifts("unique"),
                                   want._fh["unique"]["drifts"][:],
                                   atol=0.0100001)
        for rid in got.ids("unique"):
            g, gd, gf = got.load_spots("unique", int(rid))
            w, wd, wf = want.load_spots("unique", int(rid))
            assert gf == wf == 2 and len(g) == len(w) > 0
            _fits_agree(g[:, :9] - np.r_[0, gd, [0] * 5],
                        w[:, :9] - np.r_[0, wd, [0] * 5])
            np.testing.assert_allclose(
                got.load_image("unique", int(rid)).astype(np.int32),
                want.load_image("unique", int(rid)).astype(np.int32),
                atol=1)


def test_cell_list_population_map(port_runs, scene):
    cl, jl = _facade(port_runs, scene), _jax_list(scene)
    cells, jcells = cl._create_cells("unique"), jl._create_cells("unique")
    assert len(cells) == len(jcells) == 1
    for rid, sp in jcells[0].cand_spots.items():
        np.testing.assert_array_equal(cells[0].cand_spots[rid], sp)
    pop, n_used = cl._calculate_population_map()
    want, n_want = jl._calculate_population_map()
    assert pop.shape == (4, 4) and n_used == n_want >= 1
    assert np.isfinite(pop[np.triu_indices(4, 1)]).any()
    np.testing.assert_allclose(pop, want, rtol=1e-6, equal_nan=True)
    _same_traces(cells[0].picked_traces, jcells[0].picked_traces)
    mean_map, _ = cl._calculate_population_map(stat_type="mean")
    np.testing.assert_allclose(
        mean_map, jl._calculate_population_map(stat_type="mean")[0],
        rtol=1e-6, equal_nan=True)
    contact, _, all_maps = cl._calculate_population_map(
        stat_type="contact", contact_th=1e9, return_all_maps=True)
    off = contact[np.triu_indices(4, 1)]
    assert np.all(off[np.isfinite(off)] >= 0) and np.nanmax(off) <= 1
    assert np.nanmax(off) == 1.0
    assert all_maps.ndim == 3
    jc, _, jall = jl._calculate_population_map(
        stat_type="contact", contact_th=1e9, return_all_maps=True)
    np.testing.assert_array_equal(contact, jc)
    np.testing.assert_allclose(all_maps, jall, rtol=1e-6, equal_nan=True)
    # the port's own run picks the same traces from its own fits
    _, _, _, own = port_runs
    own._create_cells("unique")
    own_pop, own_n = own._calculate_population_map()
    assert own_n == n_want
    np.testing.assert_allclose(own_pop, want, rtol=1e-3, atol=1.0,
                               equal_nan=True)


def test_cell_data_rna_merge_and_crop(port_runs, scene):
    cl, jl = _facade(port_runs, scene), _jax_list(scene)
    dna, jdna = cl._create_cells("unique")[0], jl._create_cells("unique")[0]
    rna = _cell({1: np.zeros((2, 11), np.float32)})
    rna.gene_counts = {"GENE1": 3}
    jrna = JCell({1: np.zeros((2, 11), np.float32)})
    jrna.gene_counts = {"GENE1": 3}
    added = dna._merge_RNA_to_DNA(rna)
    assert "rna-gene_counts" in added
    assert dna.rna_gene_counts == {"GENE1": 3}
    assert dna.rna_cand_spots[1].shape == (2, 11)
    assert added == jdna._merge_RNA_to_DNA(jrna)
    assert dna._merge_RNA_to_DNA(rna) == jdna._merge_RNA_to_DNA(jrna) == []
    assert dna._merge_RNA_to_DNA(rna, overwrite=True) == \
        jdna._merge_RNA_to_DNA(jrna, overwrite=True)

    seg = np.zeros(SHAPE, np.int32)
    seg[:, 40:80, 30:90] = 1
    with FovStore(cl.driver.store_path(FOV), "r") as store:
        crops = CellData._crop_images(store, "unique", seg, 1,
                                      extend_dim=4)
        with pytest.raises(ValueError, match="absent"):
            CellData._crop_images(store, "unique", seg, 7)
    with JaxStore(jl.driver.store_path(FOV), "r") as store:
        want = JCell._crop_images(store, "unique", seg, 1, extend_dim=4)
    assert len(crops) == 4 and list(crops) == list(want)
    for rid, im in crops.items():
        assert im.shape == (SHAPE[0], 80 - 40 + 8, 90 - 30 + 8)
        np.testing.assert_array_equal(im, want[rid])


def test_crop_images_needs_stored_images(port_runs, scene, tmp_path):
    """A store without corrected images: the crop raises as JAX's does;
    the disk variant reads the same crops as JAX's from the movies."""
    backend, _, _, _ = port_runs
    root, _, _ = scene
    cl = CellList(str(root), str(tmp_path), cfg=_cfg(tcfg), device="cpu",
                  store_backend=backend)
    cl._process_fovs()
    seg = np.zeros(SHAPE, np.int32)
    seg[:, 40:80, 30:90] = 1
    with FovStore(cl.driver.store_path(FOV), "r") as store:
        with pytest.raises(KeyError, match="save_images"):
            CellData._crop_images(store, "unique", seg, 1)
    jl = _jax_list(scene)
    got = CellData._crop_images_from_disk(cl.driver, FOV, "unique", seg, 1,
                                          extend_dim=4, region_ids=[1, 3])
    want = JCell._crop_images_from_disk(jl.driver, FOV, "unique", seg, 1,
                                        extend_dim=4, region_ids=[1, 3])
    assert list(got) == list(want) == [1, 3]
    for rid in want:
        assert got[rid].shape == np.asarray(want[rid]).shape
        assert np.isfinite(got[rid]).all()


def test_cell_list_segmented_cells_and_batch_loads(port_runs, scene):
    cl, jl = _facade(port_runs, scene), _jax_list(scene)
    with FovStore(cl.driver.store_path(FOV), "r") as store:
        total = sum(len(v) for v in store.load_all_spots("unique").values())
    cells, jcells = cl._create_cells_fov(FOV), jl._create_cells_fov(FOV)
    assert [c.cell_id for c in cells] == [c.cell_id for c in jcells] == [1, 2]
    assert all(c.fov_name == FOV for c in cells)
    got = 0
    for cell, jcell in zip(cells, jcells):
        assert list(cell.cand_spots) == list(jcell.cand_spots)
        for rid, sp in cell.cand_spots.items():
            np.testing.assert_array_equal(sp, jcell.cand_spots[rid])
            got += len(sp)
            if len(sp):
                y = sp[:, 3]
                assert np.all(y < 64) if cell.cell_id == 1 \
                    else np.all(y >= 64)
    assert got == total > 0

    drifts = cl._load_drift()
    jdrifts = jl._load_drift()
    np.testing.assert_array_equal(drifts[FOV], jdrifts[FOV])
    assert cells[0]._check_drift() == jcells[0]._check_drift() is True
    for attr in ("drift_ids", "drifts", "drift_flags"):
        np.testing.assert_array_equal(getattr(cells[1], attr),
                                      getattr(jcells[1], attr))
    assert cells[0].drifts.shape[1] == 3
    assert cells[0].drifts is not cells[1].drifts
    assert not _cell({}, fov_name=FOV)._check_drift()

    cl._load_segmentation()
    jl._load_segmentation()
    for cell, jcell in zip(cells, jcells):
        np.testing.assert_array_equal(cell.segmentation_label,
                                      jcell.segmentation_label)
        np.testing.assert_array_equal(cell.segmentation_crop,
                                      jcell.segmentation_crop)
    seg, crop = cells[0].segmentation_label, cells[0].segmentation_crop
    assert seg.shape == SHAPE and set(np.unique(seg)) == {-1, 1}
    assert crop[1][0] == 0 and crop[1][1] <= 64 + 20

    crops, jcrops = cl._crop_image_for_cells("unique"), \
        jl._crop_image_for_cells("unique")
    assert list(crops) == list(jcrops)
    for idx in jcrops:
        assert list(crops[idx]) == list(jcrops[idx])
        for rid in jcrops[idx]:
            np.testing.assert_array_equal(crops[idx][rid], jcrops[idx][rid])
    region = next(iter(crops[len(cl.cells) - 2].values()))
    assert region.shape[0] == SHAPE[0] and region.shape[2] <= 64 + 20

    picks = ([[] for _ in range(len(cl.cells) - 2)]
             + [[np.array([6.0, 64.0, 32.0])]])
    cl._update_chromosomes_for_cells(picks)
    jl._update_chromosomes_for_cells(picks)
    assert len(cells[0].chrom_coords) == 1
    assert cells[1].chrom_coords == []

    cl._spot_finding_for_cells("unique", th_seed=400.0)
    jl._spot_finding_for_cells("unique", th_seed=400.0)
    assert set(cells[0].cand_spots) == {1, 2, 3, 4}
    for rid, sp in jcells[0].cand_spots.items():
        _fits_agree(cells[0].cand_spots[rid], sp)
    with pytest.raises(ValueError):
        cl._update_chromosomes_for_cells(
            [[] for _ in range(len(cl.cells) + 1)])


def test_spot_finding_reads_each_image_once_per_fov(port_runs, scene,
                                                    monkeypatch):
    """Two cells with chromosomes: one read (and one upload) of each region
    image for the FOV, and each cell's candidates equal to its own
    per-cell call on per-cell reads."""
    cl = _facade(port_runs, scene)
    cells = cl._create_cells_fov(FOV)
    cl._update_chromosomes_for_cells([[np.array([6.0, 64.0, 32.0]),
                                       np.array([5.0, 30.0, 20.0])],
                                      [np.array([6.0, 70.0, 100.0])]])
    reads = []
    load = FovStore.load_image

    def counted(self, data_type, region_id):
        reads.append(region_id)
        return load(self, data_type, region_id)

    monkeypatch.setattr(FovStore, "load_image", counted)
    cl._spot_finding_for_cells("unique", th_seed=400.0, fit_window=24)
    assert sorted(reads) == [1, 2, 3, 4]
    monkeypatch.setattr(FovStore, "load_image", load)
    for cell in cells:
        with FovStore(cl.driver.store_path(FOV), "r") as store:
            ims = {int(r): store.load_image("unique", int(r))
                   for r in store.ids("unique")}
        one = _cell({}, chrom_coords=cell.chrom_coords)
        want = one._multi_fitting_for_chromosome(ims, th_seed=400.0,
                                                 fit_window=24)
        assert list(cell.cand_spots) == list(want)
        for rid in want:
            np.testing.assert_array_equal(cell.cand_spots[rid], want[rid])


@pytest.fixture(scope="module")
def dapi_scene(tmp_path_factory):
    """tests/test_legacy.py's DAPI scene (seed 9, round 1 channel 0 marked
    DAPI), through the JAX facade once."""
    import csv

    root = tmp_path_factory.mktemp("exp_dapi")
    jsyn.write_synthetic_experiment(str(root), shape=SHAPE, n_rounds=2,
                                    n_spots=8, seed=9, buffer_frames=4)
    cu = root / "Color_Usage.csv"
    rows = list(csv.reader(open(cu)))
    rows[2][1] = "DAPI"
    with open(cu, "w", newline="") as fh:
        csv.writer(fh).writerows(rows)
    jl = JList(str(root), str(tmp_path_factory.mktemp("dapi_jax")),
               cfg=_cfg(jcfg))
    jl._process_fovs()
    jl._create_cells("unique")
    return root, jl._load_dapi_image()[FOV]


@pytest.mark.parametrize("backend", BACKENDS)
def test_cell_list_dapi_image(backend, dapi_scene, tmp_path):
    root, want = dapi_scene
    cl = CellList(str(root), str(tmp_path / "save"), cfg=_cfg(tcfg),
                  device="cpu", store_backend=backend)
    cl._process_fovs()
    cl._create_cells("unique")
    ims = cl._load_dapi_image()
    assert ims[FOV].shape == SHAPE
    assert cl.cells[0].dapi_im is ims[FOV]
    np.testing.assert_allclose(ims[FOV], want, rtol=1e-5, atol=1e-2)
    with FovStore(cl.driver.store_path(FOV), "r") as store:
        assert store.backend == backend
        cached = store.load_signal("dapi_im")
    np.testing.assert_allclose(cached, ims[FOV], atol=0.5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_cell_list_dependent_maps_and_transfer(backend, tmp_path):
    """Flag-gated maps (reference _generate_dependent_maps, ternary flags:
    the port's +1/-1 pools are JAX's truthy/falsy ones here) and the
    store-side data-type clone on both backends."""
    rng = np.random.default_rng(33)
    cells, jcells = [], []
    for i in range(6):
        cand, _ = _cand_spots(rng, n_regions=12)
        for lst, cls, kw in ((cells, CellData, {"device": "cpu"}),
                             (jcells, JCell, {})):
            c = cls(cand, fov_name=FOV, **kw)
            c._pick_spots(method="naive")
            c._generate_distance_map()
            if i < 3:
                c.distance_maps = [m * 0.5 for m in c.distance_maps]
            lst.append(c)
    for c, jc in zip(cells, jcells):
        np.testing.assert_allclose(c.distance_maps[0], jc.distance_maps[0],
                                   rtol=1e-6, equal_nan=True)
    suffix = ".hdf5" if backend == "h5py" else ".fovstore"

    def store_path(self, fov):
        return os.path.join(str(tmp_path), fov + suffix)

    cl, jl = _fake_lists(cells, jcells, str(tmp_path),
                         store_path=store_path)
    dep = cl._generate_dependent_maps([[1]] * 3 + [[-1]] * 3,
                                      stat_type="median")
    jdep = jl._generate_dependent_maps([[1]] * 3 + [[0]] * 3,
                                       stat_type="median")
    on_map, n_on = dep["on"]
    off_map, n_off = dep["off"]
    assert n_on == 3 and n_off == 3
    tri = np.triu_indices_from(on_map, k=1)
    assert np.nanmedian(on_map[tri]) < 0.6 * np.nanmedian(off_map[tri])
    for key in ("on", "off"):
        np.testing.assert_allclose(dep[key][0], jdep[key][0], rtol=1e-6,
                                   equal_nan=True)
    with pytest.raises(ValueError):
        cl._generate_dependent_maps([[{7: 1}]] * 6)
    dep2 = cl._generate_dependent_maps(
        [[{7: 1 if i < 3 else -1}] for i in range(6)], gene_id=7)
    np.testing.assert_allclose(dep2["on"][0], on_map, equal_nan=True)

    path = store_path(None, FOV)
    spots = np.arange(33, dtype=np.float32).reshape(3, 11)
    with FovStore(path, "a", backend=backend) as store:
        store.init_data_type("unique", region_ids=[1, 2],
                             channels=["750", "647"], spot_capacity=3)
        store.save_spots("unique", 1, spots, spots, np.zeros(3))
    assert cl._transfer_data_type("unique", "rna-unique") == [FOV]
    with FovStore(path, "r") as store:
        assert store.backend == backend
        assert "rna-unique" in store.data_types()
        got_spots, _, _ = store.load_spots("rna-unique", 1)
        np.testing.assert_array_equal(got_spots, spots)
        with pytest.raises(KeyError):
            store.transfer_data_type("unique", "rna-unique")
        store_ids = store.ids("unique")
    with FovStore(path, "a") as store:
        store.transfer_data_type("unique", "rna-unique", overwrite=True)
        np.testing.assert_array_equal(store.ids("rna-unique"), store_ids)


# ---------------------------------------------------------------------------
# per-cell cases (no driver)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("center", [None, [10.0, 46.0, 46.0]])
def test_cell_data_pick_methods(center):
    """tests/test_legacy.py's picks, and each method's traces and picks
    equal to JAX's (EM scores rtol 2e-4); the distance maps at rtol
    1e-6."""
    rng = np.random.default_rng(0)
    cand, zxys = _cand_spots(rng)
    chrom = None if center is None else [np.asarray(center)]
    cell = _cell(cand, chrom_coords=chrom)
    jcell = JCell(cand, chrom_coords=chrom)
    for method in ("EM", "dynamic", "naive"):
        traces = cell._pick_spots(method=method)
        assert len(traces) == 1 and traces[0].shape == (20, 11)
        _same_traces(traces, jcell._pick_spots(method=method))
        assert set(cell.picked[0]) == set(jcell.picked[0])
        if "sel_idx" in cell.picked[0]:
            np.testing.assert_array_equal(cell.picked[0]["sel_idx"],
                                          jcell.picked[0]["sel_idx"])
        if "scores" in cell.picked[0]:
            np.testing.assert_allclose(cell.picked[0]["scores"],
                                       jcell.picked[0]["scores"],
                                       rtol=2e-4, atol=1e-5)
    em_trace = cell._pick_spots(method="EM")[0]
    jcell._pick_spots(method="EM")
    got = em_trace[:, 1:4] * [200.0, 108, 108]
    err = np.linalg.norm(got - zxys, axis=1)
    assert np.median(err) < 100.0
    dms = cell._generate_distance_map()
    assert dms[0].shape == (20, 20) and dms[0].dtype == np.float32
    np.testing.assert_allclose(dms[0], jcell._generate_distance_map()[0],
                               rtol=1e-6, equal_nan=True)


def test_cell_data_save_load_roundtrip(tmp_path):
    """The `.npz` checkpoint round-trips and crosses between the packages
    both ways."""
    rng = np.random.default_rng(2)
    cand, _ = _cand_spots(rng)
    cell = _cell(cand, chrom_coords=[np.array([6.0, 60.0, 60.0])])
    cell._pick_spots(method="EM")
    cell._generate_distance_map()
    p = str(tmp_path / "cell0.npz")
    cell._save_to_file(p)
    for back in (CellData._load_from_file(p, device="cpu"),
                 JCell._load_from_file(p)):
        assert set(back.cand_spots) == set(cand)
        np.testing.assert_array_equal(back.cand_spots[3], cand[3])
        np.testing.assert_array_equal(back.chrom_coords[0],
                                      cell.chrom_coords[0])
        np.testing.assert_array_equal(back.picked_traces[0],
                                      cell.picked_traces[0])
        np.testing.assert_array_equal(back.distance_maps[0],
                                      cell.distance_maps[0])
    jcell = JCell(cand, chrom_coords=[np.array([6.0, 60.0, 60.0])])
    jcell._pick_spots(method="EM")
    jcell._generate_distance_map()
    jp = str(tmp_path / "jax_cell.npz")
    jcell._save_to_file(jp)
    with np.load(p) as a, np.load(jp) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6,
                                       equal_nan=True)
    back = CellData._load_from_file(jp, device="cpu")
    _same_traces(back.picked_traces, jcell.picked_traces)
    assert back._device == CPU


def test_cell_data_check_full_set_and_background():
    rng = np.random.default_rng(4)
    cand, _ = _cand_spots(rng, n_regions=6)
    cell = _cell(cand)
    assert cell._check_full_set(range(6))
    assert not cell._check_full_set(range(7))
    ims = {"750": [np.full((4, 8, 8), 100.0) + i for i in range(3)],
           "647": [torch.full((4, 8, 8), 50.0)]}
    bg = CellData._calculate_background(ims, function_type="median")
    assert bg["750"] == pytest.approx(101.0)
    assert bg["647"] == pytest.approx(50.0)
    jims = {"750": ims["750"], "647": [np.full((4, 8, 8), 50.0)]}
    for ft in ("median", "mean"):
        assert CellData._calculate_background(ims, ft, 2) == \
            JCell._calculate_background(jims, ft, 2)
    with pytest.raises(KeyError):
        CellData._calculate_background(ims, function_type="max")


@pytest.fixture(scope="module")
def chromosome_scene():
    """tests/test_legacy.py's chromosome image and one region image of a
    spot near each chromosome, with the JAX facade's identification and
    multi-fit on them."""
    rng = np.random.default_rng(7)
    shape = (12, 96, 96)
    chrom_centers = np.array([[6.0, 30.0, 30.0], [6.0, 70.0, 64.0]])
    base = jsyn.render_spots_device(
        shape, chrom_centers, np.array([3000.0, 2800.0]),
        background=100.0, sigma_zxy=(2.0, 4.0, 4.0))
    chrom_im = np.asarray(jsyn.noisy_uint16_device(base, seed=1),
                          np.float32)
    spot_centers = chrom_centers + [[0.0, 3.0, -2.0], [0.0, -3.0, 2.0]]
    im = np.asarray(jsyn.noisy_uint16_device(
        jsyn.render_spots_device(shape, spot_centers,
                                 np.array([2500.0, 2500.0]),
                                 background=100.0), seed=2), np.float32)
    jcell = JCell({})
    coords = jcell._identify_chromosomes(chrom_im, th_seed=500.0,
                                         expected_per_nucleus=2)
    out = jcell._multi_fitting_for_chromosome({5: im}, fit_window=24,
                                              th_seed=400.0,
                                              max_seed_count=4)
    del rng
    return chrom_im, im, chrom_centers, spot_centers, coords, out


def test_cell_data_identify_and_multifit(chromosome_scene):
    chrom_im, im, chrom_centers, spot_centers, jcoords, jout = \
        chromosome_scene
    cell = _cell({})
    coords = cell._identify_chromosomes(chrom_im, th_seed=500.0,
                                        expected_per_nucleus=2)
    assert len(cell.chrom_coords) >= 2
    d = np.linalg.norm(coords[:, None] - chrom_centers[None], axis=2)
    assert (d.min(axis=0) < 3.0).all()
    np.testing.assert_array_equal(coords, jcoords)
    out = cell._multi_fitting_for_chromosome({5: torch.as_tensor(im)},
                                             fit_window=24, th_seed=400.0,
                                             max_seed_count=4)
    assert 5 in out and len(out[5]) >= 2
    dd = np.linalg.norm(out[5][:, None, 1:4] - spot_centers[None], axis=2)
    assert (dd.min(axis=0) < 0.5).all()
    _fits_agree(out[5], jout[5])
    assert cell.cand_spots is out
    with pytest.raises(AttributeError, match="chrom_coords"):
        _cell({})._multi_fitting_for_chromosome({5: im})


def test_cell_list_intensity_stats_and_pval():
    rng = np.random.default_rng(9)
    cand, _ = _cand_spots(rng)
    cl, jl = _fake_lists([_cell(cand)], [JCell(cand)])
    stats = cl._get_intensity_stats()
    assert stats == jl._get_intensity_stats()
    assert set(stats) == set(range(20))
    pooled = cand[0][:, 0]
    assert stats[0]["mean"] == pytest.approx(float(np.mean(pooled)))
    flags = cl._p_value_filter(pval_th=(1e-6, 0.01))
    jflags = jl._p_value_filter(pval_th=(1e-6, 0.01))
    for rid in jflags[0]:
        np.testing.assert_array_equal(flags[0][rid], jflags[0][rid])
    f0 = flags[0][0]
    assert f0.dtype == np.int8 and set(np.unique(f0)) <= {-1, 0, 1}
    hot = dict(cand)
    hot[0] = hot[0].copy()
    hot[0][0, 0] = stats[0]["mean"] + 10 * stats[0]["std"]
    cl.cells = [_cell(hot)]
    flags = cl._p_value_filter(pval_th=(1e-6, 0.01),
                               ref_dist_params=stats)
    assert flags[0][0][0] == 1
    assert cl.cells[0].pval_flags is flags[0]


@pytest.mark.parametrize("method", ["basic", "iterative", "insulation",
                                    "sliding-window", "contact-correlation"])
def test_cell_data_domain_calling_and_batch(method):
    """Every domain caller's starts equal JAX's on the same EM pick."""
    rng = np.random.default_rng(11)
    cand, _ = _cand_spots(rng, n_regions=24)
    cell, jcell = _cell(cand), JCell(cand)
    cell._pick_spots(method="EM")
    jcell._pick_spots(method="EM")
    starts = cell._domain_calling(method=method)
    assert starts.ndim == 1 and starts[0] == 0
    np.testing.assert_array_equal(starts, jcell._domain_calling(method))
    with pytest.raises(ValueError):
        cell._domain_calling(method="nope")
    cl, _ = _fake_lists([cell], [])
    batch = cl._batch_domain_calling(method=method)
    np.testing.assert_array_equal(batch[0][0], starts)


def test_cell_list_save_load_cells(tmp_path):
    rng = np.random.default_rng(13)
    cands = [_cand_spots(rng)[0] for _ in range(3)]
    cl, jl = _fake_lists([_cell(c) for c in cands], [JCell(c)
                                                     for c in cands],
                         str(tmp_path))
    paths = cl._save_cells_to_files()
    assert len(paths) == 3
    cl2, jl2 = _fake_lists([], [], str(tmp_path))
    cells = cl2._load_cells_from_files()
    assert len(cells) == 3 and all(c._device == CPU for c in cells)
    np.testing.assert_array_equal(cells[1].cand_spots[2],
                                  cl.cells[1].cand_spots[2])
    jcells = jl2._load_cells_from_files()
    for c, jc in zip(cells, jcells):
        for rid in jc.cand_spots:
            np.testing.assert_array_equal(c.cand_spots[rid],
                                          jc.cand_spots[rid])


def test_visualize_picked_spots_matches_jax():
    import matplotlib
    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(15)
    cand, _ = _cand_spots(rng, n_regions=8)
    for rows in cand.values():
        rows[:, 1:4] = np.abs(rows[:, 1:4]) % [12, 64, 64]
    im = rng.uniform(0, 100, (12, 64, 64))
    cell, jcell = _cell(cand), JCell(cand)
    ax = cell._visualize_picked_spots(torch.as_tensor(im))
    jax_ax = jcell._visualize_picked_spots(im)
    np.testing.assert_array_equal(ax.images[0].get_array(),
                                  jax_ax.images[0].get_array())
    for a, b in zip(ax.lines, jax_ax.lines):
        np.testing.assert_allclose(a.get_xydata(), b.get_xydata(),
                                   rtol=1e-6)
    plt.close("all")


def _old_experiment(rng):
    from imageanalysis3_tpu.analysis.partition import (
        translate_label_image, translate_volume)
    import jax.numpy as jnp

    z, x, y = 8, 96, 96
    labels = np.zeros((z, x, y), np.int32)
    for lid, (cx, cy) in enumerate([(30, 30), (64, 60), (40, 72)], 1):
        zz, xx, yy = np.indices((z, x, y))
        r2 = ((xx - cx) ** 2 + (yy - cy) ** 2) / 10.0 ** 2 \
            + ((zz - z / 2) ** 2) / 3.0 ** 2
        labels[r2 < 1.0] = lid
    dapi = (labels > 0).astype(np.float32) * 800.0 \
        + rng.normal(0, 5.0, (z, x, y)).astype(np.float32)
    th = np.deg2rad(3.0)
    rot = np.array([[np.cos(th), -np.sin(th)],
                    [np.sin(th), np.cos(th)]], np.float32)
    true_drift = np.array([1.0, 2.5, -3.5], np.float32)
    new_labels = np.asarray(translate_label_image(
        jnp.asarray(labels), jnp.asarray(rot), jnp.asarray(true_drift)))
    new_dapi = np.asarray(translate_volume(
        jnp.asarray(dapi), jnp.asarray(rot), jnp.asarray(true_drift)))
    return labels, dapi, rot, new_labels, new_dapi


def test_cell_list_translate_old_segmentations(tmp_path):
    labels, dapi, rot, new_labels, new_dapi = _old_experiment(
        np.random.default_rng(21))
    old_seg, old_dapi_dir = tmp_path / "old_seg", tmp_path / "old_dapi"
    old_seg.mkdir()
    old_dapi_dir.mkdir()
    np.save(old_seg / "Conv_zscan_00_segmentation.npy", labels)
    np.save(old_dapi_dir / "Conv_zscan_00.npy", dapi)
    cl, jl = _fake_lists([_cell({}, fov_name=FOV)],
                         [JCell({}, fov_name=FOV)],
                         str(tmp_path / "save"))
    cl.driver.fovs = jl.driver.fovs = [FOV]
    got = cl._translate_old_segmentations(
        str(old_seg), str(old_dapi_dir), rot,
        new_dapi_by_fov={FOV: new_dapi})
    lab = got[FOV]
    inter = np.sum((lab > 0) & (new_labels > 0))
    union = np.sum((lab > 0) | (new_labels > 0))
    assert inter / union > 0.9
    for lid in (1, 2, 3):
        a, b = lab == lid, new_labels == lid
        assert np.sum(a & b) / np.sum(a | b) > 0.85
    assert cl.cells[0].segmentation_label is lab
    saved = os.path.join(cl.driver.save_folder, "Segmentation",
                         "Conv_zscan_00_segmentation.npy")
    assert os.path.exists(saved)
    got2 = cl._translate_old_segmentations(
        str(old_seg), str(old_dapi_dir), rot,
        new_dapi_by_fov={FOV: new_dapi})
    np.testing.assert_array_equal(got2[FOV], lab)
    want = jl._translate_old_segmentations(
        str(old_seg), str(old_dapi_dir), rot, save=False,
        new_dapi_by_fov={FOV: new_dapi})[FOV]
    np.testing.assert_array_equal(lab, want)


class _Cfg:
    image_size = (9, 200, 200)


def _coords_cells(cls, **kw):
    def make(fov, cid, crop, coords=None):
        c = cls({}, fov_name=fov, cell_id=cid, **kw)
        c.segmentation_crop = np.asarray(crop)
        if coords is not None:
            c.chrom_coords = [np.asarray(x, float) for x in coords]
        return c

    src = make("f0", 1, [[20, 60], [30, 70]], coords=[[4.0, 45.0, 55.0]])
    tar = make("f0", 1, [[25, 65], [28, 68]])
    lone = make("f1", 2, [[0, 10], [0, 10]])
    return src, tar, lone


def _rotation(deg=10.0):
    th = np.deg2rad(deg)
    return np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])


def test_cell_list_translate_chromosome_coords():
    rot = _rotation()
    (src, tar, lone), (jsrc, jtar, jlone) = \
        _coords_cells(CellData, device="cpu"), _coords_cells(JCell)
    src_cl, jsrc_cl = _fake_lists([src], [jsrc], cfg=_Cfg)
    tar_cl, jtar_cl = _fake_lists([tar, lone], [jtar, jlone], cfg=_Cfg)
    got = tar_cl._translate_chromosome_coords(src_cl, rot,
                                              rotation_order="forward")
    want = jtar_cl._translate_chromosome_coords(jsrc_cl, rot,
                                                rotation_order="forward")
    assert got[1] is None and want[1] is None
    np.testing.assert_array_equal(got[0][0], want[0][0])
    rel = np.array([45.0, 55.0]) - np.array([40.0, 50.0])
    want_xy = rot @ rel + np.array([45.0, 48.0])
    np.testing.assert_allclose(got[0][0][1:], want_xy, atol=1e-9)
    assert got[0][0][0] == 4.0
    assert tar.chrom_coords is not None
    back = src_cl._translate_chromosome_coords(
        tar_cl, rot, rotation_order="reverse", overwrite=True)
    np.testing.assert_allclose(back[0][0], [4.0, 45.0, 55.0], atol=1e-9)
    for args in [(2, 42, 30, 70, 200, 10), (160, 198, 170, 196, 200, 10),
                 (5, 45, 3, 40, 200, 10), (100, 195, 50, 150, 200, 10),
                 (50, 90, 60, 100, 200, 10)]:
        from imageanalysis3_tpu.legacy import _border_aware_centers as jb
        assert L._border_aware_centers(*args) == jb(*args)
    s, t = L._border_aware_centers(2, 42, 30, 70, 200, border_lim=10)
    assert (s, t) == (42 - 20.0, 70 - 20.0)
    s, t = L._border_aware_centers(160, 198, 170, 196, 200, border_lim=10)
    assert (s, t) == (160 + 19.0, 170 + 19.0)
    with pytest.raises(ValueError):
        tar_cl._translate_chromosome_coords(src_cl, np.eye(3))
    with pytest.raises(ValueError):
        tar_cl._translate_chromosome_coords(src_cl, rot, "sideways")


# ---------------------------------------------------------------------------
# hazard 4: the reference's semantics, each beside a strict-xfail parity
# case against the JAX facade
# ---------------------------------------------------------------------------


def _flag_cells(cls, **kw):
    """Three cells of one chromosome each: maps 1, 2 and 3 times one
    random map."""
    rng = np.random.default_rng(41)
    base = rng.uniform(100, 900, (10, 10))
    base = (base + base.T) / 2
    np.fill_diagonal(base, 0)
    cells = []
    for k in (1.0, 2.0, 3.0):
        c = cls({}, fov_name=FOV, **kw)
        c.distance_maps = [base * k]
        cells.append(c)
    return cells, base


def test_dependent_maps_ternary_flags():
    """Flags [1, -1, 0]: on, off and in neither pool; array flags reduce
    by max (the reference's np.max(flag) > 0)."""
    cells, base = _flag_cells(CellData, device="cpu")
    cl, _ = _fake_lists(cells, [])
    dep = cl._generate_dependent_maps([[1], [-1], [0]])
    assert dep["on"][1] == 1 and dep["off"][1] == 1
    np.testing.assert_allclose(dep["on"][0], base)
    np.testing.assert_allclose(dep["off"][0], 2 * base)
    dep = cl._generate_dependent_maps(
        [[np.array([-1, 1])], [np.array([-1, 0])], [np.array([0, 0])]])
    np.testing.assert_allclose(dep["on"][0], base)
    assert dep["off"] is None
    dep = cl._generate_dependent_maps([[0], [0], [-2]])
    assert dep["on"] is None and dep["off"][1] == 1
    dep = cl._generate_dependent_maps([[{3: 1}], [{3: -1}], [{3: 0}]],
                                      gene_id=3)
    assert dep["on"][1] == dep["off"][1] == 1


@pytest.mark.xfail(strict=True, reason=HAZARD4 + ": flags split by "
                   "truthiness (-1 on, 0 off)")
def test_dependent_maps_ternary_flags_jax_parity():
    cells, _ = _flag_cells(CellData, device="cpu")
    jcells, _ = _flag_cells(JCell)
    cl, jl = _fake_lists(cells, jcells)
    flags = [[1], [-1], [0]]
    got, want = cl._generate_dependent_maps(flags), \
        jl._generate_dependent_maps(flags)
    for key in ("on", "off"):
        assert (got[key] is None) == (want[key] is None)
        if got[key] is not None:
            assert got[key][1] == want[key][1]
            np.testing.assert_allclose(got[key][0], want[key][0])


def _interior_pair(cls, **kw):
    """A source and a target cell far from every FOV edge, with crops of
    different extents (no driver cfg, so no image size)."""
    src = cls({}, fov_name="f0", cell_id=1, **kw)
    src.segmentation_crop = np.array([[300, 360], [400, 450]])
    src.chrom_coords = [np.array([3.0, 330.0, 420.0])]
    tar = cls({}, fov_name="f0", cell_id=1, **kw)
    tar.segmentation_crop = np.array([[310, 380], [390, 446]])
    return src, tar


def test_translate_chromosome_coords_without_cfg_keeps_midpoints():
    """No cfg: the FOV is unbounded, so interior cells rotate about their
    crop midpoints (no high-border re-anchoring)."""
    src, tar = _interior_pair(CellData, device="cpu")
    src_cl, _ = _fake_lists([src], [])
    tar_cl, _ = _fake_lists([tar], [])
    got = tar_cl._translate_chromosome_coords(src_cl, np.eye(2),
                                              rotation_order="forward")
    s_mid = np.array([0.0, 330.0, 425.0])
    t_mid = np.array([0.0, 345.0, 418.0])
    np.testing.assert_allclose(got[0][0], src.chrom_coords[0] - s_mid
                               + t_mid)
    # the low border is still the FOV's edge at 0
    s, t = L._border_aware_centers(2, 42, 30, 70, np.inf, 10)
    assert (s, t) == (22.0, 50.0)


@pytest.mark.xfail(strict=True, reason=HAZARD4 + ": fov_lim guessed from "
                   "the crops when the driver has no cfg")
def test_translate_chromosome_coords_without_cfg_jax_parity():
    src, tar = _interior_pair(CellData, device="cpu")
    jsrc, jtar = _interior_pair(JCell)
    src_cl, jsrc_cl = _fake_lists([src], [jsrc])
    tar_cl, jtar_cl = _fake_lists([tar], [jtar])
    got = tar_cl._translate_chromosome_coords(src_cl, np.eye(2),
                                              rotation_order="forward")
    want = jtar_cl._translate_chromosome_coords(jsrc_cl, np.eye(2),
                                                rotation_order="forward")
    np.testing.assert_allclose(got[0][0], want[0][0])


def test_translate_chromosome_coords_overwrites_by_default():
    """The reference's force=True: a target cell's existing coordinates
    are replaced unless overwrite=False."""
    src, tar, _ = _coords_cells(CellData, device="cpu")
    stale = [np.array([1.0, 2.0, 3.0])]
    tar.chrom_coords = stale
    src_cl, _ = _fake_lists([src], [], cfg=_Cfg)
    tar_cl, _ = _fake_lists([tar], [], cfg=_Cfg)
    kept = tar_cl._translate_chromosome_coords(src_cl, _rotation(),
                                               overwrite=False)
    assert tar.chrom_coords is stale
    got = tar_cl._translate_chromosome_coords(src_cl, _rotation())
    assert tar.chrom_coords is got[0]
    np.testing.assert_array_equal(got[0][0], kept[0][0])


@pytest.mark.xfail(strict=True, reason=HAZARD4 + ": overwrite=False by "
                   "default keeps stale coordinates")
def test_translate_chromosome_coords_default_jax_parity():
    src, tar, _ = _coords_cells(CellData, device="cpu")
    jsrc, jtar, _ = _coords_cells(JCell)
    tar.chrom_coords = [np.array([1.0, 2.0, 3.0])]
    jtar.chrom_coords = [np.array([1.0, 2.0, 3.0])]
    src_cl, jsrc_cl = _fake_lists([src], [jsrc], cfg=_Cfg)
    tar_cl, jtar_cl = _fake_lists([tar], [jtar], cfg=_Cfg)
    tar_cl._translate_chromosome_coords(src_cl, _rotation())
    jtar_cl._translate_chromosome_coords(jsrc_cl, _rotation())
    np.testing.assert_array_equal(tar.chrom_coords[0], jtar.chrom_coords[0])


# ---------------------------------------------------------------------------
# the package boundary
# ---------------------------------------------------------------------------


def test_legacy_runs_on_the_card_by_default(scene, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CellData({})
    root, _, _ = scene
    with pytest.raises(RuntimeError, match="CUDA"):
        CellList(str(root), str(tmp_path), cfg=_cfg(tcfg))
    cl = CellList(str(root), str(tmp_path), cfg=_cfg(tcfg), device="cpu")
    assert cl.device == CPU == cl.driver.device
