"""PyTorch port vs JAX package: cell location tables on the CPU.

A label volume of irregular cells (one touching the volume's edge, label
ids with gaps) is measured by both packages: the port's table equals the
JAX DataFrame column for column (volumes and boxes exactly, centres too:
integer coordinate sums are exact in float64), through the DataFrame
facade by ``assert_frame_equal``; several planes a pass give the same
table as one.  Position files, translation and merging equal the JAX
package's on the same inputs, column tables and DataFrames alike.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from imageanalysis3_tpu.analysis import cell_locations as jcl
from imageanalysis3_tpu_torch.analysis import cell_locations as tcl

torch.set_num_threads(2)


def _labels(seed=0, shape=(12, 64, 64)):
    rng = np.random.default_rng(seed)
    lab = np.zeros(shape, np.int32)
    z, x, y = np.indices(shape)
    for cid, (c, r) in zip((1, 2, 5, 9), [((6, 15, 15), 9.0),
                                          ((5, 40, 20), 11.0),
                                          ((7, 30, 50), 8.0),
                                          ((3, 60, 62), 7.0)]):
        d = (((z - c[0]) / 0.6) ** 2 + (x - c[1]) ** 2 + (y - c[2]) ** 2)
        lab[(d <= r * r) & (rng.uniform(size=shape) > 0.05)] = cid
    return lab


def test_segmentation_to_cell_locations_matches_jax(monkeypatch):
    lab = _labels()
    want = jcl.segmentation_to_cell_locations(lab, fov_id=3)
    got = tcl.segmentation_to_cell_locations_dataframe(lab, fov_id=3,
                                                       device="cpu")
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    table = tcl.segmentation_to_cell_locations(lab, 3, device="cpu")
    assert list(table) == list(want.columns)
    # a few planes a pass: the same table
    monkeypatch.setattr(tcl, "_CHUNK_VOXELS", 3 * 64 * 64)
    chunked = tcl.segmentation_to_cell_locations(lab, 3, device="cpu")
    for c in table:
        np.testing.assert_array_equal(chunked[c], table[c])
    assert tcl.segmentation_to_cell_locations(np.zeros((2, 4, 4), np.int32),
                                              device="cpu") == {}


@pytest.mark.parametrize("text", ["10,20\n30,40\n", "1.5,2\n-3,4.25\n"])
def test_load_position_file_matches_jax(tmp_path, text):
    path = tmp_path / "position.txt"
    path.write_text(text)
    pd.testing.assert_frame_equal(tcl.load_position_file_dataframe(str(path)),
                                  jcl.load_position_file(str(path)))


def test_translate_and_merge_match_jax():
    df = jcl.segmentation_to_cell_locations(_labels(1), fov_id=0)
    table = tcl.segmentation_to_cell_locations(_labels(1), 0, device="cpu")
    pos = [(0.0, 100.0, 200.0), (0.0, 100.0 + 2.5, 200.0),
           (0.0, 300.0, 200.0)]
    want = [jcl.translate_cell_locations(df, p) for p in pos]
    got = [tcl.translate_cell_locations(table, p) for p in pos]
    for g, w in zip(got, want):
        pd.testing.assert_frame_equal(pd.DataFrame(g), w)
    pd.testing.assert_frame_equal(
        tcl.translate_cell_locations_dataframe(df, pos[0]), want[0])
    for sel in ([0, 1], [0, 2], [0, 1, 2]):
        w = jcl.merge_cell_locations([want[k] for k in sel],
                                     duplicate_distance_um=4.0)
        g = tcl.merge_cell_locations_dataframe(
            [got[k] for k in sel], duplicate_distance_um=4.0, device="cpu")
        pd.testing.assert_frame_equal(g, w)
        g2 = tcl.merge_cell_locations_dataframe(
            [want[k] for k in sel], duplicate_distance_um=4.0, device="cpu")
        pd.testing.assert_frame_equal(g2, w)
    assert tcl.merge_cell_locations([], device="cpu") == {}
