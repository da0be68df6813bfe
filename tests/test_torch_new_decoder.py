"""PyTorch port vs JAX package: the decode front doors over spot tables,
on the CPU.

``SpotDecoder`` (combinatorial): the decoded groups compared as sets of
(region, member spots) -- near-equal neighbours come back in a
platform-dependent order (ROADMAP hazard 9) -- its saved tables, and
``load_groups``.  ``SpotMapper`` (sequential): the mapped table equal to
JAX's DataFrame, ``spots_by_region`` equal, the saved table equal, in both
file backends; tables given as dicts of NumPy columns or as DataFrames.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch
from pandas.testing import assert_frame_equal

from imageanalysis3_tpu.decode import new_decoder as jnd
from imageanalysis3_tpu.io.spots import load_dataframe_hdf5 as jload
from imageanalysis3_tpu.io.spots import spots_to_dataframe
from imageanalysis3_tpu_torch.decode import new_decoder as tnd
from imageanalysis3_tpu_torch.io import spots as tio

torch.set_num_threads(2)

PX = np.array([200.0, 108.0, 108.0])


def _codebook(n_genes=6, n_bits=16, n_on=2, seed=0):
    rng = np.random.default_rng(seed)
    rows, used = [], set()
    while len(rows) < n_genes:
        on = tuple(sorted(rng.choice(n_bits, n_on, replace=False)))
        if on in used:
            continue
        used.add(on)
        rows.append(on)
    data = {"name": [f"chr1:{i*1000}-{i*1000+500}" for i in range(n_genes)],
            "id": np.arange(n_genes) + 50}
    for b in range(n_bits):
        data[str(b + 1)] = [int(b in on) for on in rows]
    return pd.DataFrame(data)


def _cand_table(cb_df, seed=1, n_tuples=12):
    rng = np.random.default_rng(seed)
    cb, _ = jnd.codebook_dataframe_to_tables(cb_df)
    spots, bits = [], []
    for _ in range(n_tuples):
        g = rng.integers(0, len(cb.matrix))
        center = rng.uniform(3000, 15000, 3)
        for b in cb.bit_values[cb.matrix[g] > 0]:
            row = np.zeros(11)
            row[0] = rng.uniform(800, 1500)
            row[1:4] = (center + rng.normal(0, 40, 3)) / PX
            spots.append(row)
            bits.append(int(b))
    return spots_to_dataframe(np.asarray(spots), bits, ["647"] * len(bits),
                              fov_id=0, cell_id=1)


def _group_set(df):
    return {(int(r), tuple(sorted(int(i) for i in sub["spot_index"])))
            for (g, r), sub in df.groupby(["group_id", "region_id"])}


def test_codebook_tables_match_jax():
    df = _codebook()
    cb_t, meta_t = tnd.codebook_dataframe_to_tables(
        {c: df[c].to_numpy() for c in df.columns})
    cb_j, meta_j = jnd.codebook_dataframe_to_tables(df)
    for name in ("matrix", "ids", "bit_values"):
        np.testing.assert_array_equal(getattr(cb_t, name),
                                      getattr(cb_j, name))
    assert list(meta_t) == list(meta_j.columns)


@pytest.mark.parametrize("as_dict", [False, True])
def test_spot_decoder_matches_jax(as_dict, tmp_path):
    cb_df = _codebook(seed=3)
    cand = _cand_table(cb_df, seed=4)
    jdec = jnd.SpotDecoder(cand, cb_df, save_file=str(tmp_path / "j.h5"))
    want = jdec.groups_dataframe()
    args = (({c: cand[c].to_numpy() for c in cand.columns},
             {c: cb_df[c].to_numpy() for c in cb_df.columns}) if as_dict
            else (cand, cb_df))
    tdec = tnd.SpotDecoder(*args, save_file=str(tmp_path / "t.h5"),
                           device="cpu")
    got = tdec.groups_dataframe()
    assert len(want) > 0
    assert _group_set(got) == _group_set(want)
    # the member rows carry the same spot values
    key = ["spot_index"]
    a = got.sort_values(key).reset_index(drop=True)
    b = want.sort_values(key).reset_index(drop=True)
    assert_frame_equal(a.drop(columns=["group_id", "member"]),
                       b.drop(columns=["group_id", "member"]))
    tdec.save()
    jdec.save()
    back = tio.to_dataframe(tnd.SpotDecoder.load_groups(
        str(tmp_path / "t.h5")))
    assert_frame_equal(back, jnd.SpotDecoder.load_groups(
        str(tmp_path / "t.h5")))
    assert _group_set(back) == _group_set(jnd.SpotDecoder.load_groups(
        str(tmp_path / "j.h5")))
    assert_frame_equal(jload(str(tmp_path / "t.h5"), "cand_spots"),
                       jload(str(tmp_path / "j.h5"), "cand_spots"))


def _sequential():
    rng = np.random.default_rng(2)
    n_regions = 5
    data = {"name": [f"chr2:{i*100}-{i*100+50}" for i in range(n_regions)]
            + ["plain_name"],
            "id": np.arange(n_regions + 1) + 1}
    for b in range(9):
        data[str(b + 1)] = [int(b == i) for i in range(n_regions + 1)]
    data["9"][0] = 1        # region 1: two on-bits -> not sequential
    cb = pd.DataFrame(data)
    spots = rng.uniform(0, 50, (14, 11))
    bits = [1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3, 4, 9, 6]
    cand = spots_to_dataframe(spots, bits, ["750"] * 14, fov_id=0, cell_id=0)
    return cand, cb


@pytest.mark.parametrize("backend", ["h5py", "npy"])
def test_spot_mapper_matches_jax(backend, tmp_path):
    cand, cb = _sequential()
    jm = jnd.SpotMapper(cand, cb, save_file=str(tmp_path / "j.h5"))
    path = str(tmp_path / ("t.h5" if backend == "h5py" else "t.tables"))
    if backend == "npy":
        os.makedirs(path)          # an existing directory: the .npy backend
    tm = tnd.SpotMapper({c: cand[c].to_numpy() for c in cand.columns},
                        {c: cb[c].to_numpy() for c in cb.columns},
                        save_file=path)
    want = jm.filtered_spots_df.reset_index(drop=True)
    assert_frame_equal(tm.filtered_spots_df, want)
    assert tm.bit_2_region == jm.bit_2_region
    got_r, want_r = tm.spots_by_region(), jm.spots_by_region()
    assert list(got_r) == list(want_r)
    for r in want_r:
        np.testing.assert_array_equal(got_r[r], want_r[r])
    saved = tio.load_dataframe_hdf5(path, "sequential_spots")
    assert_frame_equal(saved, jload(str(tmp_path / "j.h5"),
                                    "sequential_spots"))
