"""PyTorch port vs JAX package: experiment metadata (``io.color_usage``),
crop boxes (``io.crop``) and microscope geometry (``io.microscope``).

Every loader and matcher reads the same files in both packages and must
give equal results; ``microscope_correct_image`` on a tensor must equal
the JAX function on the same NumPy array, exactly."""

import json
import os

import numpy as np
import pytest
import torch

from imageanalysis3_tpu import synthetic as jsyn
from imageanalysis3_tpu.io import color_usage as jcu
from imageanalysis3_tpu.io import crop as jcrop
from imageanalysis3_tpu.io import microscope as jmic
from imageanalysis3_tpu_torch.io import color_usage as tcu
from imageanalysis3_tpu_torch.io import crop as tcrop
from imageanalysis3_tpu_torch.io import microscope as tmic
from imageanalysis3_tpu_torch.io import write_dax

TABLES = {
    "RNA_Info.csv":
        "RNA_id,gene_name,chr,strand,start,end,midpoint\n"
        "r13,CYP4F29P,chr21,-,13848364,13843133,13845748.5\n"
        "r14,OTHER,chr21,+,20000100,20000900,20000500.0,\n",
    "Gene_Info.csv":
        "gene_id,gene_name,chr,strand,TSS_position,readout\n"
        "2,HSPA13,chr21,-,14383484,NDB_1159\n"
        "5,FAR,chr21,+,90000100,NDB_1160\n",
    "CTCF_ChIP-Seq_chr21.csv":
        "chr,start,end,midpoint,fold\n"
        "chr21,14000000,14000400,14000200,7.5\n"
        "chr21,13850000,13850400,13850200,1.5\n"
        "chr21,90000000,90000400,90000200,2.0\n",
    "Region_Positions.csv":
        "region,chr,start,end,midpoint\n"
        "1,chr21,13800000,13900000,13850000\n"
        "2,chr21,14000000,14500000,\n",
    "Encoding_Scheme.csv":
        "hyb,750,647\n"
        "num_hyb,3\n"
        "num_reg,4\n"
        "H0R0,1,2\n"
        "H1R1,3,\n",
    "Color_Usage.csv":
        "Hyb,750,647,561,488,405\n"
        "H0R0,u1,u2,beads,,DAPI\n"
        "H1R1,u3,u4,beads,,\n"
        "H2R2,c1,c2,beads,,\n",
}


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    root = tmp_path_factory.mktemp("meta")
    for name, text in TABLES.items():
        (root / name).write_text(text)
    (root / "Color_Usage.tsv").write_text(
        TABLES["Color_Usage.csv"].replace(",", "\t"))
    return str(root)


def test_color_usage_matches_jax(tables):
    for path in (tables, os.path.join(tables, "Color_Usage.tsv")):
        want, got = jcu.load_color_usage(path), tcu.load_color_usage(path)
        assert (got.channels, got.usage, got.has_dapi) == \
            (want.channels, want.usage, want.has_dapi)
        assert got.bead_channel_index() == want.bead_channel_index() == 2
        assert got.dapi_channel_index() == want.dapi_channel_index() == 4
        assert got.folders() == want.folders()
        for folder in got.folders():
            assert got.regions_of(folder) == want.regions_of(folder)


def test_synthetic_experiment_color_usage_and_folders(tmp_path):
    truth = jsyn.write_synthetic_experiment(
        str(tmp_path), shape=(4, 16, 16), n_rounds=3, n_spots=2, seed=0,
        buffer_frames=2)
    want, got = (jcu.load_color_usage(str(tmp_path)),
                 tcu.load_color_usage(str(tmp_path)))
    assert (got.channels, got.usage) == (want.channels, want.usage)
    assert got.bead_channel_index() == 2 and got.dapi_channel_index() is None
    # numeric hyb order (H10 after H2), non-H and dax-less folders skipped
    for name in ("H10R10", "Analysis", "H11_empty"):
        os.makedirs(tmp_path / name)
    write_dax(str(tmp_path / "H10R10" / "Conv_zscan_00.dax"),
              np.zeros((2, 4, 4), np.uint16))
    write_dax(str(tmp_path / "Analysis" / "Conv_zscan_00.dax"),
              np.zeros((2, 4, 4), np.uint16))
    folders, fovs = tcu.find_hyb_folders(str(tmp_path))
    assert (folders, fovs) == jcu.find_hyb_folders(str(tmp_path))
    assert [os.path.basename(f) for f in folders] == \
        [os.path.basename(f) for f in truth["folders"]] + ["H10R10"]
    assert fovs == ["Conv_zscan_00.dax"]


@pytest.mark.parametrize("usage, error", [
    ({"H1R1": ["u1", "beads"], "H2R2": ["beads", "u2"]}, "bead"),
    ({"H1R1": ["DAPI", "beads"], "H2R2": ["beads", "dapi"]}, "dapi"),
])
def test_channel_uniqueness_errors_match_jax(usage, error):
    got = tcu.ColorUsage(channels=["750", "647"], usage=usage)
    want = jcu.ColorUsage(channels=["750", "647"], usage=usage)
    method = ("bead_channel_index" if error == "bead"
              else "dapi_channel_index")
    with pytest.raises(ValueError, match="not unique") as e_got:
        getattr(got, method)()
    with pytest.raises(ValueError, match="not unique") as e_want:
        getattr(want, method)()
    assert str(e_got.value) == str(e_want.value)


def test_long_tail_loaders_and_matchers_match_jax(tables):
    for name in ("load_rna_info", "load_gene_info", "load_region_positions",
                 "load_encoding_scheme"):
        assert getattr(tcu, name)(tables) == getattr(jcu, name)(tables), name
    peaks = tcu.load_chip_data(tables, "CTCF")
    assert peaks == jcu.load_chip_data(tables, "CTCF")
    regions = {1: {"chr": "chr21", "start": 13800000, "end": 13900000},
               2: {"chr": "chr21", "start": 14000000, "end": 14500000}}
    rx, ry = tcu.match_peaks_to_regions(regions, peaks)
    jx, jy = jcu.match_peaks_to_regions(regions, peaks)
    np.testing.assert_array_equal(rx, jx)
    np.testing.assert_array_equal(ry, jy)
    assert tcu.match_peaks_to_regions(regions, peaks, return_arrays=False) \
        == jcu.match_peaks_to_regions(regions, peaks, return_arrays=False)
    rna, genes = tcu.load_rna_info(tables), tcu.load_gene_info(tables)
    assert tcu.match_rna_to_dna(rna, regions) == \
        jcu.match_rna_to_dna(rna, regions)
    assert tcu.match_gene_to_dna(genes, regions) == \
        jcu.match_gene_to_dna(genes, regions)
    enh = {"e1": {"start": 13895000, "end": 13905000},
           "e2": {"start": 14100000, "end": 14100400}}
    assert tcu.match_enhancers_to_dna(enh, regions) == \
        jcu.match_enhancers_to_dna(enh, regions)


@pytest.mark.parametrize("center, size", [
    ([5, 10, 10], 6), ([0, 0, 0], 6), ([7.5, 31.2, 2.0], [3, 8, 5])])
def test_image_crop_matches_jax(center, size):
    image_size = (8, 32, 32)
    got = tcrop.ImageCrop3D.from_center(center, size, image_size=image_size)
    want = jcrop.ImageCrop3D.from_center(center, size, image_size=image_size)
    np.testing.assert_array_equal(got.array, want.array)
    assert got.shape == want.shape and got.to_slices() == want.to_slices()
    other = np.array([[4, 10], [10, 20], [0, 9]])
    o_got = got.overlap(tcrop.ImageCrop3D(other, image_size))
    o_want = want.overlap(jcrop.ImageCrop3D(other, image_size))
    assert (o_got is None) == (o_want is None)
    if o_got is not None:
        np.testing.assert_array_equal(o_got.array, o_want.array)
    drift = [0.6, -1.5, 2.4]
    np.testing.assert_array_equal(got.translate_drift(drift).array,
                                  want.translate_drift(drift).array)
    pts = np.array([[5.0, 10.0, 10.0], [0.0, 0.0, 0.0], [7.9, 31.5, 3.0]])
    np.testing.assert_array_equal(got.contains(pts), want.contains(pts))
    np.testing.assert_array_equal(got.relative_coords(pts),
                                  want.relative_coords(pts))
    im = np.arange(8 * 32 * 32).reshape(image_size)
    np.testing.assert_array_equal(got.crop(im), want.crop(im))
    np.testing.assert_array_equal(
        tcrop.generate_neighboring_crop(center, size, image_size).array,
        jcrop.generate_neighboring_crop(center, size, image_size).array)


@pytest.mark.parametrize("params", [
    {"transpose": True, "flip_horizontal": True, "flip_vertical": False},
    {"transpose": False, "flip_horizontal": False, "flip_vertical": True},
    {"transpose": True, "flip_horizontal": True, "flip_vertical": True},
    {},
])
def test_microscope_geometry_matches_jax(params, tmp_path):
    p = tmp_path / "microscope.json"
    p.write_text(json.dumps(params))
    assert tmic.read_microscope_json(str(p)) == \
        jmic.read_microscope_json(str(p))
    rng = np.random.default_rng(3)
    im = rng.normal(size=(4, 8, 6)).astype(np.float32)
    for a in (im, im[1]):
        want = jmic.microscope_correct_image(a, params)
        np.testing.assert_array_equal(tmic.microscope_correct_image(a,
                                                                    params),
                                      want)
        got_t = tmic.microscope_correct_image(torch.from_numpy(a), params)
        assert isinstance(got_t, torch.Tensor)
        np.testing.assert_array_equal(got_t.numpy(), want)
    spots = rng.uniform(0, 6, size=(5, 11)).astype(np.float32)
    np.testing.assert_array_equal(
        tmic.microscope_translate_spots(spots, params, (4, 6, 8)),
        jmic.microscope_translate_spots(spots, params, (4, 6, 8)))
    with pytest.raises(TypeError):
        tmic.microscope_correct_image(torch.from_numpy(im), None)
    with pytest.raises(ValueError):
        tmic.microscope_correct_image(torch.from_numpy(im[0, 0]), params)


def test_position_file_matches_jax(tmp_path):
    p = tmp_path / "positions.txt"
    p.write_text("1.5,2.0\n-3.25,4.0\n")
    np.testing.assert_array_equal(tmic.load_position_file(str(p)),
                                  jmic.load_position_file(str(p)))
    (tmp_path / "bad.txt").write_text("1,2,3\n")
    with pytest.raises(ValueError, match="columns"):
        tmic.load_position_file(str(tmp_path / "bad.txt"))
