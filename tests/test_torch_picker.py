"""PyTorch port vs JAX package: the table picker (``decode/picker.py``) on
the CPU.

The numeric core runs in float64 on the port's device, its sums in
another order than NumPy's loops: ``cdf_scores``, the metric tensor,
weighted k-means, the scores and the homolog centres are held at rtol
1e-10; the picks, the filtered picks, ``n_iterations`` and the change
fractions EQUAL to ``SpotPicker.iterative_assignment``'s on planted
tables where no two assignments tie.  The two quirks the JAX package
documents are pinned: ``allow_overlap`` enumerates ``product(range(n),
repeat=k)``, and the X/Y copy numbers are always set.  Files: a decoded
file written by the JAX package (HDF5) or in the port's ``.npy`` layout
through ``batch_pick_spots``, and the ``save_picked`` / ``load_picked``
round trip.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch
from pandas.testing import assert_frame_equal

from imageanalysis3_tpu.decode import picker as jpk
from imageanalysis3_tpu.io.spots import save_dataframe_hdf5 as jsave
from imageanalysis3_tpu_torch.decode import picker as tpk
from imageanalysis3_tpu_torch.io import spots as tio

torch.set_num_threads(2)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_cdf_scores_match_jax():
    rng = np.random.default_rng(0)
    refs = rng.normal(10, 3, 200)
    refs[::17] = np.nan                      # NaNs stay in the pool
    refs[5] = refs[6]                        # a tie in the pool
    vals = np.concatenate([rng.normal(10, 3, 50), [np.nan, refs[6]]])
    for greater in (True, False):
        want = jpk.cdf_scores(vals, refs, greater=greater)
        got = tpk.cdf_scores(vals, refs, greater=greater, device="cpu")
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
        assert np.isnan(got.numpy()[-2]) == np.isnan(want[-2])
    nan_pool = tpk.cdf_scores(torch.ones(3), torch.full((4,), float("nan")))
    assert torch.isnan(nan_pool).all()


def test_metrics_match_jax():
    rng = np.random.default_rng(1)
    n = 80
    hzxys = np.column_stack([rng.uniform(100, 1000, n),
                             rng.normal(0, 5, (n, 3)) + 50])
    hzxys[7, 2] = np.nan                     # a NaN coordinate
    ids = rng.integers(0, 25, n)
    ids[-1] = 60                             # a lone region
    centers = np.array([[48.0, 50.0, 52.0], [55.0, 45.0, 50.0]])
    for lr in (5, 2):
        want = jpk.prepare_score_metrics_by_chr(hzxys, ids, centers,
                                                local_range=lr)
        got = tpk.prepare_score_metrics_by_chr(hzxys, ids, centers,
                                               local_range=lr, device="cpu")
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                   equal_nan=True)
    prev = rng.normal(50, 5, (2, 25, 4))
    prev[0, 3] = np.nan
    prev[1, 10:20] = np.nan                  # an all-NaN window
    want = jpk.prepare_score_metrics_by_chr(hzxys, ids, centers,
                                            prev_homolog_hzxys=prev)
    got = tpk.prepare_score_metrics_by_chr(
        torch.from_numpy(hzxys), torch.from_numpy(ids),
        torch.from_numpy(centers), prev_homolog_hzxys=torch.from_numpy(prev))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, equal_nan=True)
    with pytest.raises(IndexError):
        tpk.prepare_score_metrics_by_chr(hzxys, ids, centers,
                                         prev_homolog_hzxys=prev[:1],
                                         device="cpu")


@pytest.mark.parametrize("k", [1, 2, 3])
def test_weighted_kmeans_matches_jax(k):
    rng = np.random.default_rng(2)
    pts = np.concatenate([rng.normal(c, 3.0, (40, 3))
                          for c in ([0, 0, 0], [30, 5, 0], [0, 40, 10])])
    pts[4] = np.nan
    w = rng.uniform(0.2, 1.0, len(pts))
    want = jpk.weighted_kmeans(pts, w, k)
    got = tpk.weighted_kmeans(pts, w, k, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
    with pytest.raises(ValueError):
        tpk.weighted_kmeans(pts[:2], w[:2], 3, device="cpu")


CHROMS = (("1", 40, 2), ("2", 16, 2), ("X", 12, 1))


def planted_table(rng, chroms=CHROMS, n_decoys=3, sparse=False, sep=40.0):
    """Per chromosome, `copies` homolog traces `sep` px apart (a random
    walk of 2 px steps), each region holding one jittered true spot per
    homolog and `n_decoys` dim spread decoys; with `sparse` some regions
    lose candidates (fewer candidates than homologs, or none)."""
    rows, names, chrs = [], [], []
    for chrom, n_regions, copies in chroms:
        starts = rng.permutation(n_regions) * 1_000_000 + 500_000
        base = rng.uniform(20, 30, 3)
        walks = [base + [0.0, sep * h, sep * h]
                 + np.cumsum(rng.normal(0, 2.0, (n_regions, 3)), 0)
                 for h in range(copies)]
        for r in range(n_regions):
            name = f"{chrom}:{int(starts[r])}-{int(starts[r] + 400_000)}"
            names.append(name)
            chrs.append(chrom)
            cands = []
            for h in range(copies):
                cands.append((walks[h][r] + rng.normal(0, 0.3, 3),
                              rng.uniform(800, 1500)))
            for _ in range(n_decoys):
                cands.append((base + rng.normal(0, 20.0, 3),
                              rng.uniform(200, 700)))
            if sparse and r % 7 == 3:
                cands = cands[:1]
            if sparse and r % 11 == 5:
                cands = []
            for zxy, h in cands:
                rows.append({"region_name": name, "chr": chrom,
                             "start": float(starts[r]),
                             "end": float(starts[r] + 400_000),
                             "center_z": zxy[0], "center_x": zxy[1],
                             "center_y": zxy[2], "center_intensity": h,
                             "center_internal_dist": rng.uniform(0, 1)})
    coords = pd.DataFrame(rows).sample(frac=1.0, random_state=3).reset_index(
        drop=True)
    codebook = pd.DataFrame({"name": names, "chr": chrs,
                             "id": np.arange(len(names))})
    return coords, codebook


def _as_table(df):
    return {c: df[c].to_numpy() for c in df.columns}


def _assert_pickers_agree(t, j):
    assert list(t.chr_2_homolog_inds) == list(j.chr_2_homolog_inds)
    assert t.chr_2_copy_num == j.chr_2_copy_num
    assert t.n_iterations == j.n_iterations
    assert t.chr_2_change == j.chr_2_change
    assert t.chr_2_change_fraction == j.chr_2_change_fraction
    for c in j.chr_2_homolog_inds:
        np.testing.assert_array_equal(_np(t.chr_2_homolog_inds[c]),
                                      j.chr_2_homolog_inds[c])
        np.testing.assert_array_equal(_np(t.chr_2_homolog_hzxys[c]),
                                      j.chr_2_homolog_hzxys[c])
        np.testing.assert_array_equal(_np(t.chr_2_filtered_inds[c]),
                                      j.chr_2_filtered_inds[c])
        np.testing.assert_allclose(_np(t.chr_2_homolog_centers[c]),
                                   j.chr_2_homolog_centers[c], rtol=1e-10)
        np.testing.assert_allclose(_np(t.chr_2_scores[c]), j.chr_2_scores[c],
                                   rtol=1e-10)
    mc = j.merged_coords
    for col in mc.columns:
        if col.startswith("score_h"):
            np.testing.assert_allclose(t.merged_coords[col],
                                       mc[col].to_numpy(), rtol=1e-10,
                                       equal_nan=True)
    for col in ("index", "chr_order"):
        np.testing.assert_array_equal(t.merged_coords[col],
                                      mc[col].to_numpy())
    np.testing.assert_array_equal(t.merged_codebook["chr_order"],
                                  j.merged_codebook["chr_order"].to_numpy())


@pytest.mark.parametrize("sparse", [False, True])
def test_iterative_assignment_matches_jax(sparse):
    rng = np.random.default_rng(7 + sparse)
    coords, codebook = planted_table(rng, sparse=sparse)
    j = jpk.SpotPicker(coords=coords, codebook=codebook)
    j.iterative_assignment(max_niter=10)
    t = tpk.SpotPicker(coords=_as_table(coords), codebook=_as_table(codebook),
                       device="cpu")
    t.iterative_assignment(max_niter=10)
    assert j.n_iterations >= 2
    _assert_pickers_agree(t, j)
    assert_frame_equal(t.picked_dataframe(), j.picked_dataframe())
    assert_frame_equal(t.picked_dataframe(filtered=False),
                       j.picked_dataframe(filtered=False))
    if not sparse:
        # the planted traces come back: every pick a true spot of one
        # homolog (intensity >= 800)
        for c in t.chr_2_homolog_hzxys:
            assert (_np(t.chr_2_homolog_hzxys[c])[..., 0] >= 800).all()


def test_quirks_are_pinned():
    """allow_overlap enumerates product(range(n), repeat=k), and the X/Y
    copy numbers are set whether or not the codebook holds them."""
    rng = np.random.default_rng(11)
    # homologs on top of each other: with overlap both may take one spot
    coords, codebook = planted_table(rng, chroms=(("1", 24, 2),
                                                  ("5", 10, 3)),
                                     sparse=True, sep=0.0)
    for male in (True, False):
        j = jpk.SpotPicker(coords=coords, codebook=codebook, male=male)
        j.iterative_assignment(max_niter=3, allow_overlap=True)
        t = tpk.SpotPicker(coords=coords, codebook=codebook, male=male,
                           device="cpu")
        t.iterative_assignment(max_niter=3, allow_overlap=True)
        assert t.chr_2_copy_num == {"1": 2, "5": 2, "X": 1 if male else 2,
                                    "Y": 1 if male else 0}
        _assert_pickers_agree(t, j)
    # overlap lets two homologs take one candidate: it happens here
    shared = [(_np(t.chr_2_homolog_inds[c])[0] >= 0)
              & (_np(t.chr_2_homolog_inds[c])[0]
                 == _np(t.chr_2_homolog_inds[c])[1])
              for c in t.chr_2_homolog_inds]
    assert any(s.any() for s in shared)
    # copy numbers given explicitly are kept; a 3-copy chromosome with
    # fewer candidates than homologs in some regions
    j = jpk.SpotPicker(coords=coords, codebook=codebook,
                       chr_2_copy_num={"1": 2, "5": 3})
    j.iterative_assignment(max_niter=4)
    t = tpk.SpotPicker(coords=coords, codebook=codebook,
                       chr_2_copy_num={"1": 2, "5": 3}, device="cpu")
    t.iterative_assignment(max_niter=4)
    _assert_pickers_agree(t, j)


def test_score_filter_matches_jax():
    rng = np.random.default_rng(3)
    coords, codebook = planted_table(rng, chroms=(("1", 20, 2),))
    kw = dict(chr_2_copy_num={"1": 2}, valid_score_th=-0.0001)
    j = jpk.SpotPicker(coords=coords, codebook=codebook, **kw)
    j.iterative_assignment(max_niter=3)
    t = tpk.SpotPicker(coords=coords, codebook=codebook, device="cpu", **kw)
    t.iterative_assignment(max_niter=3)
    removed = (_np(t.chr_2_filtered_inds["1"]) == -1) & \
        (_np(t.chr_2_homolog_inds["1"]) >= 0)
    assert removed.any()
    assert np.isnan(_np(t.chr_2_filtered_hzxys["1"])[removed]).all()
    _assert_pickers_agree(t, j)


def _write_decoded(path, coords, codebook, writer):
    """A decoded file with one combo and one unique library."""
    half = len(coords) // 2
    combo = coords.iloc[:half].copy()
    combo["height_0"] = 100.0
    combo["height_1"] = np.nan
    unique = coords.iloc[half:].copy()
    for name, key, df in (("libA", "spotGroups", combo),
                          ("libB", "candSpots", unique)):
        writer(df, path, f"{name}/{key}")
        writer(codebook, path, f"{name}/codebook")


@pytest.mark.parametrize("layout", ["jax_hdf5", "port_npy"])
def test_batch_pick_and_round_trip_match_jax(layout, tmp_path):
    rng = np.random.default_rng(5)
    coords, codebook = planted_table(rng, chroms=(("1", 20, 2),
                                                  ("X", 8, 1)))
    jdec = str(tmp_path / "decoded.hdf5")
    _write_decoded(jdec, coords, codebook, jsave)
    if layout == "jax_hdf5":
        tdec = jdec
        tpicked = str(tmp_path / "picked_port.hdf5")
    else:
        tdec = str(tmp_path / "decoded.tables")
        os.makedirs(tdec)
        _write_decoded(tdec, coords, codebook, tio.save_dataframe_hdf5)
        tpicked = str(tmp_path / "picked.tables")
        os.makedirs(tpicked)
    j = jpk.batch_pick_spots(jdec, str(tmp_path / "picked.hdf5"),
                             num_expected_lib=2)
    t = tpk.batch_pick_spots(tdec, tpicked, num_expected_lib=2,
                             device="cpu")
    assert t is not None and int(t.merged_coords["num_spots"][0]) == 1
    assert list(t.merged_coords["num_spots"]) == list(
        j.merged_coords["num_spots"])
    _assert_pickers_agree(t, j)
    for col in ("library", "dtype"):
        assert list(t.merged_codebook[col]) == list(j.merged_codebook[col])
    back = tpk.SpotPicker.load_picked(tpicked, device="cpu")
    for name in ("chr_2_homolog_hzxys", "chr_2_homolog_inds",
                 "chr_2_homolog_centers", "chr_2_scores",
                 "chr_2_filtered_hzxys", "chr_2_filtered_inds"):
        a, b = getattr(back, name), getattr(t, name)
        assert sorted(a) == sorted(b)
        for c in b:
            assert torch.equal(a[c].nan_to_num(-7.0), b[c].nan_to_num(-7.0))
    assert back.chr_2_copy_num == t.chr_2_copy_num
    for col in t.merged_coords:
        got = back.merged_coords[col]
        want = np.asarray(t.merged_coords[col])
        if want.dtype.kind in "biuf":
            np.testing.assert_array_equal(got, want)
        else:
            assert list(got) == [str(v) for v in want]
    assert_frame_equal(back.picked_dataframe(filtered=False),
                       t.picked_dataframe(filtered=False))
    if layout == "jax_hdf5":
        jback = jpk.SpotPicker.load_picked(tpicked)   # the port's HDF5
        for c in j.chr_2_homolog_inds:
            np.testing.assert_array_equal(jback.chr_2_homolog_inds[c],
                                          j.chr_2_homolog_inds[c])
    # the wrong library count bails out (reference guard)
    assert tpk.batch_pick_spots(tdec, tpicked, num_expected_lib=3,
                                device="cpu") is None
