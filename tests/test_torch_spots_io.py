"""PyTorch port vs JAX package: spot tables at the file boundary, the spot
datatypes and the spot render, on the CPU.

``io/spots``: the port's column tables through its DataFrame facade equal
JAX's DataFrames (``pandas.testing.assert_frame_equal``), the cand-spot
and spot-group conversions both ways, HDF5 files written by either package
load in the other, and the ``.npy`` backend round-trips bit for bit.
``Spots3D`` / ``SpotTuple`` as JAX's; ``reconstruct_spot_image`` within
rtol 1e-5 / atol 1e-6 of JAX's.
"""

import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from pandas.testing import assert_frame_equal

from imageanalysis3_tpu import spots as jspots
from imageanalysis3_tpu.decode.merfish import SpotGroups as JSpotGroups
from imageanalysis3_tpu.io import spots as jio
from imageanalysis3_tpu_torch import spots as tspots
from imageanalysis3_tpu_torch.decode.merfish import SpotGroups
from imageanalysis3_tpu_torch.io import spots as tio

torch.set_num_threads(2)


def _spots(n, seed=0):
    return np.random.default_rng(seed).uniform(0, 100, (n, 11)).astype(
        np.float32)


CASES = {
    "plain": dict(),
    "bits_channels_valid": dict(bits=np.arange(1, 9),
                                channels=["750"] * 4 + ["647"] * 4,
                                valid=np.arange(8) != 5, fov_id=3,
                                cell_id=7, uid="u1"),
    "per_row_cells": dict(bits=np.arange(8), cell_id=np.arange(8) % 3,
                          fov_id=0, pixel_sizes=(250.0, 100.0, 100.0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spots_dataframe_matches_jax(case):
    kw = CASES[case]
    spots = _spots(8)
    want = jio.spots_to_dataframe(spots, **kw)
    got = tio.spots_to_dataframe(torch.from_numpy(spots), **kw)
    assert_frame_equal(got, want)
    table = tio.spots_to_table(spots, **kw)
    assert list(table) == list(want.columns)
    for a, b in zip(tio.table_to_cand_spots(table),
                    jio.dataframe_to_cand_spots(want)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    # the facade takes JAX's DataFrame too
    for a, b in zip(tio.dataframe_to_cand_spots(want),
                    jio.dataframe_to_cand_spots(want)):
        np.testing.assert_array_equal(a, b)


def test_empty_spots_table():
    want = jio.spots_to_dataframe(np.zeros((0, 11)))
    assert_frame_equal(tio.spots_to_dataframe(np.zeros((0, 11))), want)
    spots, bits, ch, px = tio.table_to_cand_spots(
        tio.spots_to_table(np.zeros((0, 11))))
    assert spots.shape == (0, 11) and len(bits) == 0
    np.testing.assert_array_equal(px, [200.0, 108.0, 108.0])


def _groups():
    idx = np.array([[0, 1, 2, -1], [3, -1, 4, -1], [-1, -1, -1, -1],
                    [5, 6, -1, 7]], np.int32)
    region = np.array([101, 102, -1, 104], np.int32)
    n_spots = np.array([3, 2, 0, 3], np.int32)
    ok = np.array([True, True, False, True])
    return idx, region, n_spots, ok


def test_spot_groups_table_matches_jax():
    idx, region, n_spots, ok = _groups()
    spots = _spots(12, seed=1)
    bits = np.random.default_rng(1).integers(0, 16, 12)
    homolog = np.array([0, 1, -1, 1])
    jg = JSpotGroups(spot_idx=jnp.asarray(idx), region=jnp.asarray(region),
                     n_spots=jnp.asarray(n_spots), ok=jnp.asarray(ok),
                     spot_usage=jnp.zeros(12, jnp.int32))
    tg = SpotGroups(spot_idx=torch.from_numpy(idx.astype(np.int64)),
                    region=torch.from_numpy(region),
                    n_spots=torch.from_numpy(n_spots),
                    ok=torch.from_numpy(ok),
                    spot_usage=torch.zeros(12, dtype=torch.int32))
    for kw in (dict(bits=bits, fov_id=1, cell_id=2, homolog_flags=homolog),
               dict()):
        want = jio.spot_groups_to_dataframe(jg, spots, **kw)
        got = tio.spot_groups_to_dataframe(tg, torch.from_numpy(spots), **kw)
        assert_frame_equal(got, want)
    # no member at all: pixel-size columns only, as JAX's
    none = tg._replace(ok=torch.zeros(4, dtype=torch.bool))
    assert_frame_equal(
        tio.spot_groups_to_dataframe(none, spots),
        jio.spot_groups_to_dataframe(jg._replace(ok=jnp.zeros(4, bool)),
                                     spots))
    # back to groups, capacity cut included
    for cap in (None, 4, 2):
        want = jio.dataframe_to_spot_groups(
            jio.spot_groups_to_dataframe(jg, spots, bits=bits), capacity=cap)
        got = tio.dataframe_to_spot_groups(
            tio.spot_groups_to_dataframe(tg, spots, bits=bits),
            capacity=cap, device="cpu")
        for name in ("spot_idx", "region", "n_spots", "ok", "spot_usage"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))
        assert got.spot_idx.dtype == torch.int64


def test_table_to_spot_groups_orders_members():
    """Rows in any order: members sorted by `member` within a group."""
    table = {"group_id": np.array([5, 2, 5, 2, 5]),
             "region_id": np.array([9, 8, 9, 8, 9]),
             "member": np.array([2, 1, 0, 0, 1]),
             "spot_index": np.array([10, 11, 12, 13, 14])}
    want = jio.dataframe_to_spot_groups(pd.DataFrame(table))
    got = tio.table_to_spot_groups(table, device="cpu")
    np.testing.assert_array_equal(got.spot_idx.numpy(),
                                  np.asarray(want.spot_idx))
    np.testing.assert_array_equal(got.region.numpy(),
                                  np.asarray(want.region))


def _mixed_frame():
    df = jio.spots_to_dataframe(_spots(6, seed=2), np.arange(6),
                                ["647"] * 6, fov_id=0, cell_id=1)
    df["flag"] = np.array([True, False] * 3)
    df["count"] = np.arange(6, dtype=np.int32)
    return df


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_hdf5_files_cross_load(writer, tmp_path):
    df = _mixed_frame()
    path = str(tmp_path / "spots.h5")
    if writer == "jax":
        jio.save_dataframe_hdf5(df, path, "lib/cand_spots")
        got = tio.load_dataframe_hdf5(path, "lib/cand_spots")
        want = jio.load_dataframe_hdf5(path, "lib/cand_spots")
    else:
        tio.save_dataframe_hdf5(df, path, "lib/cand_spots")
        want = jio.load_dataframe_hdf5(path, "lib/cand_spots")
        got = tio.load_dataframe_hdf5(path, "lib/cand_spots")
    assert_frame_equal(got, want)
    # one layout: the same datasets, dtypes and column attribute
    import h5py
    other = str(tmp_path / "other.h5")
    (tio if writer == "jax" else jio).save_dataframe_hdf5(df, other,
                                                          "lib/cand_spots")
    with h5py.File(path) as a, h5py.File(other) as b:
        ga, gb = a["lib/cand_spots"], b["lib/cand_spots"]
        assert list(ga.attrs["columns"]) == list(gb.attrs["columns"])
        assert sorted(ga) == sorted(gb)
        for k in ga:
            assert ga[k].dtype == gb[k].dtype
            np.testing.assert_array_equal(ga[k][:], gb[k][:])


def test_npy_backend_round_trips_bit_for_bit(tmp_path):
    df = _mixed_frame()
    table = {c: df[c].to_numpy() for c in df.columns}
    path = str(tmp_path / "cell.tables")
    tio.save_table_hdf5(table, path, "cand_spots", backend="npy")
    tio.save_table_hdf5(table, path, "lib/cand_spots", backend="npy")
    assert os.path.isdir(path)
    # an existing directory opens as the .npy backend by default
    for key in ("cand_spots", "lib/cand_spots"):
        back = tio.load_table_hdf5(path, key)
        assert list(back) == list(table)
        for c in table:
            if table[c].dtype == object or table[c].dtype.kind in "US":
                # text as utf-8 S64 bytes, None as "" (the JAX layout)
                assert list(back[c]) == ["" if v is None else str(v)
                                         for v in table[c]]
            else:
                assert back[c].dtype == table[c].dtype
                assert back[c].tobytes() == table[c].tobytes()
    # the npy directory loads equal to the HDF5 file
    h5 = str(tmp_path / "cell.h5")
    tio.save_table_hdf5(table, h5, "cand_spots", backend="h5py")
    assert_frame_equal(tio.load_dataframe_hdf5(path, "cand_spots"),
                       tio.load_dataframe_hdf5(h5, "cand_spots"))
    # saving again replaces the table
    tio.save_table_hdf5({"a": np.arange(3)}, path, "cand_spots")
    assert list(tio.load_table_hdf5(path, "cand_spots")) == ["a"]


def test_spaligner_to_chr_homologs_matches_jax():
    rng = np.random.default_rng(4)
    rows = []
    for chrom in ("chr1", "2"):
        for fiber in (0, 1):
            for hyb in rng.choice(10, 6, replace=False):
                rows.append({"chr": chrom, "fiberidx": fiber, "hyb": hyb,
                             "z_um": rng.normal(), "x_um": rng.normal(),
                             "y_um": rng.normal(), "fov_id": 3,
                             "cell_id": 9})
    cell = pd.DataFrame(rows)
    cb = pd.DataFrame({"chr": ["1"] * 10 + ["2"] * 10})
    for fill in (True, False):
        got, ginfo = tio.spaligner_to_chr_homologs(cell, cb, fill_blank=fill)
        want, winfo = jio.spaligner_to_chr_homologs(cell, cb,
                                                    fill_blank=fill)
        assert list(got) == list(want) and ginfo == winfo
        for c in want:
            for a, b in zip(got[c], want[c]):
                np.testing.assert_array_equal(a, b)


def test_spots3d_and_spot_tuple_match_jax():
    rows = _spots(4, seed=5).astype(np.float64)
    for kw in (dict(bits=5, channels="647"), dict(bits=[1, 2, 3, 4]),
               dict(pixel_sizes=(250.0, 100.0, 100.0))):
        got, want = tspots.Spots3D(rows, **kw), jspots.Spots3D(rows, **kw)
        np.testing.assert_array_equal(got, want)
        for name in ("bits", "channels", "pixel_sizes"):
            a, b = getattr(got, name), getattr(want, name)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got.to_positions(),
                                      want.to_positions())
        np.testing.assert_array_equal(got[:2].to_coords(),
                                      want[:2].to_coords())
        np.testing.assert_array_equal(got.to_intensities(),
                                      want.to_intensities())
    t = tspots.SpotTuple(tspots.Spots3D(rows), bits=[1, 2, 3, 4],
                         spots_inds=[7, 9, 11, 13], tuple_id=42)
    j = jspots.SpotTuple(jspots.Spots3D(rows), bits=[1, 2, 3, 4],
                         spots_inds=[7, 9, 11, 13], tuple_id=42)
    np.testing.assert_array_equal(t.dist_internal(), j.dist_internal())
    np.testing.assert_array_equal(t.centroid_spot(), j.centroid_spot())
    np.testing.assert_array_equal(t.intensities(), j.intensities())
    assert t.tuple_id == j.tuple_id == 42


def _render_spots(n, shape, seed=6):
    rng = np.random.default_rng(seed)
    s = np.zeros((n, 11))
    s[:, 0] = rng.uniform(50, 500, n)
    s[:, 1:4] = rng.uniform(-2, np.asarray(shape) + 1, (n, 3))
    s[:, 5:8] = rng.uniform(0.8, 2.0, (n, 3))
    s[:3, 5] = 0.0              # clamped to 1e-3
    return s


@pytest.mark.parametrize("kw", [
    dict(use_intensity=True), dict(use_stds=False, given_stds=(1.2, 1.5, 1.5)),
    dict(radius=3, background=7.0)])
def test_reconstruct_spot_image_matches_jax(kw):
    shape = (14, 30, 26)
    spots = _render_spots(60, shape)
    want = jspots.reconstruct_spot_image(spots, shape, **kw)
    got = tspots.reconstruct_spot_image(spots, shape, device="cpu", **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # chunked over spots (5 a chunk here) it is the same sum
    import imageanalysis3_tpu_torch.spots as mod
    old = mod._CHUNK_ELEMENTS
    try:
        mod._CHUNK_ELEMENTS = 5 * (2 * kw.get("radius", 8) + 1) ** 3
        chunked = tspots.reconstruct_spot_image(torch.from_numpy(spots),
                                                shape, **kw)
    finally:
        mod._CHUNK_ELEMENTS = old
    np.testing.assert_allclose(chunked.numpy(), want, rtol=1e-5, atol=1e-6)


def test_reconstruct_spot_image_empty():
    got = tspots.reconstruct_spot_image(np.zeros((0, 11)), (4, 4, 4),
                                        background=7.0, device="cpu")
    want = jspots.reconstruct_spot_image(np.zeros((0, 11)), (4, 4, 4),
                                         background=7.0)
    np.testing.assert_array_equal(got.numpy(), want)
