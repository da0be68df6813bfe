"""PyTorch port vs JAX package: the .dax movie format, the native fused
loader and the on-disk synthetic experiment.  Files written by either
package load byte for byte in the other; every read equals the JAX
package's exactly, the drift-resampled crops within the image-warp
tolerance of tests/test_warp.py (rtol 1e-5, atol 1e-2)."""

import filecmp
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from imageanalysis3_tpu import synthetic as jsyn
from imageanalysis3_tpu.io import dax as jdax
from imageanalysis3_tpu.io import native_loader as jnat
from imageanalysis3_tpu_torch import synthetic as tsyn
from imageanalysis3_tpu_torch.io import dax as tdax
from imageanalysis3_tpu_torch.io import native_loader as tnat
from imageanalysis3_tpu_torch.ops.corrections import deinterleave_stack

torch.set_num_threads(2)
CHANNELS = ["750", "647", "561"]
N_Z = 6
BUF = 3


def _stacks(seed=0, shape=(N_Z, 20, 28)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 65535, shape, dtype=np.uint16)
            for _ in CHANNELS]


@pytest.fixture(scope="module")
def movie_file(tmp_path_factory):
    """One interleaved movie written by the JAX package, little-endian."""
    stacks = _stacks()
    movie = jdax.interleave_channels(stacks, buffer_frames=BUF,
                                     empty_frames=1)
    path = str(tmp_path_factory.mktemp("dax") / "Conv_zscan_00.dax")
    jdax.write_dax(path, movie, stage_x=12.5, stage_y=-3.25,
                   lock_target=1.5, scale_min=100, scale_max=5000)
    return path, stacks, movie


@pytest.mark.parametrize("big_endian", [False, True])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_dax_files_cross_load_byte_for_byte(tmp_path, big_endian, writer):
    """The two writers make the same bytes (.dax and .inf); each package
    reads what the other wrote, metadata and frames."""
    movie = np.random.default_rng(1).integers(0, 65535, (7, 9, 11),
                                              dtype=np.uint16)
    kw = dict(big_endian=big_endian, stage_x=1.25, stage_y=-7.5,
              lock_target=2.0, scale_min=10, scale_max=900)
    pj, pt = str(tmp_path / "j.dax"), str(tmp_path / "t.dax")
    jdax.write_dax(pj, movie, **kw)
    tdax.write_dax(pt, movie, **kw)
    for ext in (".dax", ".inf"):
        assert filecmp.cmp(pj[:-4] + ext, pt[:-4] + ext, shallow=False)
    src = pj if writer == "jax" else pt
    reader_t, meta_t = tdax.read_dax(src, memmap=False)
    reader_j, meta_j = jdax.read_dax(src, memmap=True)
    np.testing.assert_array_equal(reader_t, movie)
    np.testing.assert_array_equal(reader_j, movie)
    assert meta_t.big_endian == meta_j.big_endian == big_endian
    for f in ("number_frames", "image_width", "image_height", "stage_x",
              "stage_y", "lock_target", "scale_min", "scale_max"):
        assert getattr(meta_t, f) == getattr(meta_j, f), f
    out = np.empty_like(movie)
    got, _ = tdax.read_dax(src, out=out)
    np.testing.assert_array_equal(got, movie)
    assert tdax.get_num_frames_and_colors(
        src, frame_per_color=1, buffer_frames=0) == \
        jdax.get_num_frames_and_colors(src, frame_per_color=1,
                                       buffer_frames=0)


@pytest.mark.parametrize("skip_frame0", [False, True])
@pytest.mark.parametrize("sel", [["647"], ["561", "750"], CHANNELS])
def test_split_and_raw_window_match_jax(movie_file, sel, skip_frame0):
    """channel_start_frames, split_channels, raw_frame_window +
    read_raw_window (de-interleaved by deinterleave_stack) and the fused
    loader all give the JAX package's frames."""
    path, stacks, movie = movie_file
    n_z = N_Z - 1 if skip_frame0 else N_Z
    kw = dict(buffer_frames=BUF, empty_frames=1, skip_frame0=skip_frame0)
    assert tdax.channel_start_frames(sel, CHANNELS, **kw) == \
        jdax.channel_start_frames(sel, CHANNELS, **kw)
    want = jdax.split_channels(movie, sel, CHANNELS, n_z=n_z, **kw)
    got = tdax.split_channels(movie, sel, CHANNELS, n_z=n_z, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    win_t = tdax.raw_frame_window(sel, CHANNELS, n_z=n_z, **kw)
    win_j = jdax.raw_frame_window(sel, CHANNELS, n_z=n_z, **kw)
    assert tuple(win_t.__dict__.values()) == tuple(win_j.__dict__.values())
    raw = tdax.read_raw_window(path, win_t)
    np.testing.assert_array_equal(raw, jdax.read_raw_window(path, win_j))
    dein = deinterleave_stack(torch.from_numpy(raw), win_t.rel_starts,
                              win_t.n_colors, n_z)
    np.testing.assert_array_equal(dein.numpy(), np.stack(want))
    block = tnat.load_dax_channels(path, sel, CHANNELS, n_z=n_z, **kw)
    np.testing.assert_array_equal(
        block, jnat.load_dax_channels(path, sel, CHANNELS, n_z=n_z, **kw))
    np.testing.assert_array_equal(block, np.stack(want))
    np.testing.assert_array_equal(
        tnat.split_channels_native(np.ascontiguousarray(movie), sel,
                                   CHANNELS, n_z=n_z, **kw), block)


def test_native_loader_builds_and_falls_back(movie_file, monkeypatch):
    """g++ builds the port's own daxload.cpp into its build directory; a
    big-endian movie loads byteswapped; without the library the NumPy path
    gives the same block."""
    path, stacks, movie = movie_file
    assert tnat.native_loader_available()
    lib = tnat.library_path()
    assert "imageanalysis3_tpu_torch" in lib or "torch_kernels" in lib
    assert os.stat(lib).st_mode & 0o022 == 0
    kw = dict(buffer_frames=BUF, empty_frames=1)
    want = np.stack(stacks)
    big = os.path.join(os.path.dirname(path), "big.dax")
    tdax.write_dax(big, movie, big_endian=True)
    np.testing.assert_array_equal(
        tnat.load_dax_channels(big, CHANNELS, CHANNELS, n_z=N_Z, **kw), want)
    win = tdax.raw_frame_window(CHANNELS, CHANNELS, n_z=N_Z, **kw)
    np.testing.assert_array_equal(tdax.read_raw_window(big, win),
                                  jdax.read_raw_window(big, win))
    with pytest.raises(ValueError, match="frames"):
        tnat.split_channels_native(np.ascontiguousarray(movie[:-BUF - 1]),
                                   CHANNELS, CHANNELS, n_z=N_Z, **kw)
    monkeypatch.setattr(tnat, "_build_lib", lambda: None)
    out = np.zeros_like(want)
    got = tnat.load_dax_channels(path, CHANNELS, CHANNELS, n_z=N_Z,
                                 out=out, **kw)
    assert got is out
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("zstarts", [0, [0, 2]])
def test_read_dax_window_matches_jax(movie_file, zstarts):
    path, _, _ = movie_file
    kw = dict(zlims=(2, 17), xlims=(15, 3), ylims=(4, 26), zstep=3,
              zstarts=zstarts)
    got = tdax.read_dax_window(path, **kw)
    want = jdax.read_dax_window(path, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("drift", [None, (0.4, -1.3, 2.6)])
@pytest.mark.parametrize("crop", [None, [[2, -3], [5, 22]],
                                  [[1, 5], [2, 17], [3, -2]]])
def test_read_channel_crops_matches_jax(movie_file, drift, crop):
    """Drift-aware crops: the exact frames without drift, the trilinear
    resample (run on the CPU here) within the warp tolerance with it."""
    path, _, _ = movie_file
    kw = dict(all_channels=CHANNELS, n_z=N_Z, buffer_frames=BUF,
              empty_frames=1, drift=drift, return_limits=True)
    got, lim_t = tdax.read_channel_crops(path, ["561", "750"], crop,
                                         device="cpu", **kw)
    want, lim_j = jdax.read_channel_crops(path, ["561", "750"], crop, **kw)
    np.testing.assert_array_equal(lim_t, lim_j)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-2)


def test_resample_window_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdax.resample_window(np.zeros((2, 3, 4), np.uint16), (0.5, 0, 0),
                             (2, 3, 4))


def test_remove_and_interleave_match_jax(movie_file, tmp_path):
    path, stacks, movie = movie_file
    np.testing.assert_array_equal(
        tdax.interleave_channels(stacks, buffer_frames=BUF, empty_frames=1),
        movie)
    kw = dict(n_z=N_Z, buffer_frames=BUF)
    pt, pj = str(tmp_path / "t.dax"), str(tmp_path / "j.dax")
    src = str(tmp_path / "src.dax")
    tdax.write_dax(src, jdax.interleave_channels(stacks, buffer_frames=BUF))
    kept_t = tdax.remove_dax_channels(src, pt, ["561", "405", "750"],
                                      CHANNELS, **kw)
    kept_j = jdax.remove_dax_channels(src, pj, ["561", "405", "750"],
                                      CHANNELS, **kw)
    assert kept_t == kept_j == ["561", "750"]
    for ext in (".dax", ".inf"):
        assert filecmp.cmp(pt[:-4] + ext, pj[:-4] + ext, shallow=False)
    with pytest.raises(FileExistsError):
        tdax.remove_dax_channels(src, pt, ["561"], CHANNELS, **kw)


def test_synthetic_experiment_byte_identical(tmp_path):
    """One seed: the same .dax, .inf and Color_Usage.csv bytes from both
    writers, optics and calibration rounds included, and the same truth."""
    consts = np.zeros((3, 10))
    consts[:, 0] = [0.2, 0.5, -0.4]
    consts[1, 2] = 0.01
    kw = dict(shape=(8, 48, 48), n_rounds=2, n_spots=4, seed=5,
              buffer_frames=2, illumination_falloff=0.3, bleed_leak=0.05,
              chromatic_constants={"750": consts}, calibration_rounds=True)
    tj = jsyn.write_synthetic_experiment(str(tmp_path / "j"), **kw)
    tt = tsyn.write_synthetic_experiment(str(tmp_path / "t"), **kw)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "j")
                   for d, _, fs in os.walk(tmp_path / "j") for f in fs)
    assert len(files) == 2 * 2 + 3 * 2 + 1
    for f in files:
        assert filecmp.cmp(tmp_path / "j" / f, tmp_path / "t" / f,
                           shallow=False), f
    np.testing.assert_array_equal(tt["drifts"], tj["drifts"])
    for rid, reg in tj["regions"].items():
        np.testing.assert_array_equal(tt["regions"][rid]["centers"],
                                      reg["centers"])


def test_synthetic_fov_and_fields_match_jax():
    fj = jsyn.make_synthetic_fov(shape=(6, 32, 32), n_rounds=2,
                                 n_channels=2, n_spots=3, seed=2)
    ft = tsyn.make_synthetic_fov(shape=(6, 32, 32), n_rounds=2,
                                 n_channels=2, n_spots=3, seed=2)
    np.testing.assert_array_equal(ft.ims, fj.ims)
    np.testing.assert_array_equal(ft.drifts, fj.drifts)
    np.testing.assert_array_equal(ft.illumination, fj.illumination)
    coeffs = [np.linspace(-1e-3, 1e-3, 10) * (d + 1) for d in range(3)]
    np.testing.assert_array_equal(
        tsyn.chromatic_shift_field((3, 5, 4), coeffs),
        jsyn.chromatic_shift_field((3, 5, 4), coeffs))


def test_new_modules_import_without_jax_in_subprocess():
    """The on-disk path's modules import neither JAX nor the JAX package."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'imageanalysis3_tpu', 'pandas'):\n"
        "    sys.modules[m] = None\n"
        "from imageanalysis3_tpu_torch.io import dax, native_loader\n"
        "from imageanalysis3_tpu_torch.pipeline import dax_processer\n"
        "from imageanalysis3_tpu_torch import synthetic, ops, io\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'imageanalysis3_tpu', 'pandas') "
        "and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = pathlib.Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
