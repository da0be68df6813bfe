"""PyTorch port vs JAX package: DAPI nuclei segmentation and the label
screens (``segmentation.nuclei``).

Every output is discrete and must be equal: Otsu's threshold, the labels of
``propagate_labels`` (with ``max_iters`` binding at 1, 2 and 16 sweeps, on
a scene whose labels change at each of those sweeps, so one sweep more or
fewer fails), ``segment_nuclei`` (labels, seed coordinates and validity),
``segment_cells``, ``screen_labels``, ``split_oversized_nuclei``,
``merge_z_layer_masks`` and ``interpolate_z_masks``; ``_label_bboxes`` on
the device equals NumPy's.  The scenes keep seeds and thresholds far from
the float32 cuts whose reduction order differs between XLA and torch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageanalysis3_tpu import segmentation as JS
from imageanalysis3_tpu import synthetic as jsyn
from imageanalysis3_tpu.segmentation import nuclei as JN
from imageanalysis3_tpu_torch import segmentation as TS
from imageanalysis3_tpu_torch.segmentation import nuclei as TN

torch.set_num_threads(2)
CPU = "cpu"


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _nuclei_image(centers=None, shape=(12, 96, 96)):
    """The JAX tests' three Gaussian nuclei over background 80."""
    if centers is None:
        centers = np.array([[6, 24, 24], [6, 24, 70], [6, 70, 46]], float)
    im = jsyn.render_gaussian_spots(
        shape, centers, np.full(len(centers), 2000.0),
        np.tile([3.0, 8.0, 8.0], (len(centers), 1)), background=80.0)
    return im.astype(np.float32)


def _ellipsoid_mask(shape, center, radii):
    zz, xx, yy = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    return ((((zz - center[0]) / radii[0]) ** 2
             + ((xx - center[1]) / radii[1]) ** 2
             + ((yy - center[2]) / radii[2]) ** 2) <= 1.0)


def _touching_scene():
    """The JAX test's two touching nuclei in 250 x 108 x 108 nm voxels,
    a DAPI and a polyT channel with a 1.5x halo."""
    shape = (16, 96, 96)
    px = (250.0, 108.0, 108.0)
    rng = np.random.default_rng(0)
    radii = 1800.0 / np.asarray(px)
    c1, c2 = np.array([8.0, 38.0, 48.0]), np.array([8.0, 68.0, 48.0])
    nuc = _ellipsoid_mask(shape, c1, radii) | _ellipsoid_mask(shape, c2,
                                                              radii)
    dapi = 100.0 + 900.0 * nuc + rng.normal(0, 5, shape)
    halo = _ellipsoid_mask(shape, c1, radii * 1.5) | \
        _ellipsoid_mask(shape, c2, radii * 1.5)
    polyt = 100.0 + 600.0 * halo + rng.normal(0, 5, shape)
    return dapi.astype(np.float32), polyt.astype(np.float32), px


@pytest.mark.parametrize("case", ["bimodal", "nuclei", "constant"])
def test_otsu_threshold_matches_jax(case):
    rng = np.random.default_rng(0)
    if case == "bimodal":
        im = np.concatenate([rng.normal(100, 10, 4000),
                             rng.normal(1000, 50, 1000)]
                            ).astype(np.float32).reshape(50, -1)
    elif case == "nuclei":
        im = _nuclei_image()
    else:
        im = np.full((4, 8, 8), 7.0, np.float32)
    want = np.asarray(JN.otsu_threshold(jnp.asarray(im)))
    got = TN.otsu_threshold(im, device=CPU)
    assert got.dtype == torch.float32
    assert float(got) == float(want)


def _corridor_scene():
    """Seeds at both ends of a winding foreground: labels still change at
    every one of the first ~40 sweeps."""
    rng = np.random.default_rng(3)
    shape = (5, 24, 40)
    mask = rng.random(shape) < 0.75
    mask[:, :, 0:3] = True
    seeds = np.zeros(shape, np.int32)
    seeds[2, 1, 1] = 1
    seeds[2, 22, 38] = 2
    seeds[0, 12, 20] = 3
    return seeds, mask


@pytest.mark.parametrize("max_iters", [1, 2, 16, 256])
@pytest.mark.parametrize("costs", [(1.0, 1.0, 1.0), (2.3148, 1.0, 1.0)])
def test_propagate_labels_matches_jax(max_iters, costs):
    seeds, mask = _corridor_scene()
    want = np.asarray(JN.propagate_labels(
        jnp.asarray(seeds), jnp.asarray(mask), max_iters=max_iters,
        step_costs=costs))
    got = TN.propagate_labels(seeds, mask, max_iters=max_iters,
                              step_costs=costs, device=CPU)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if max_iters < 256:
        # one sweep more changes the labels: the cap binds here
        more = np.asarray(JN.propagate_labels(
            jnp.asarray(seeds), jnp.asarray(mask), max_iters=max_iters + 1,
            step_costs=costs))
        assert (more != want).any()
    else:
        # the label-quiet sweep stops it before the cap
        assert TN.propagation_sweeps() < 256


@pytest.mark.parametrize("check_every", [1, 3, 8, 100])
def test_propagate_labels_check_interval_changes_nothing(check_every,
                                                         monkeypatch):
    """The host reads the stop flag every CHECK_EVERY sweeps; the frozen
    sweeps in between leave the labels and the sweep count as they were."""
    rng = np.random.default_rng(11)
    for trial in range(4):
        shape = (6, 30, 31)
        mask = rng.random(shape) < 0.8
        seeds = np.zeros(shape, np.int32)
        for i, p in enumerate(rng.integers(0, np.array(shape), (5, 3))):
            seeds[tuple(p)] = i + 1
        want = np.asarray(JN.propagate_labels(
            jnp.asarray(seeds), jnp.asarray(mask), max_iters=64))
        monkeypatch.setattr(TN, "CHECK_EVERY", 1)
        ref = TN.propagate_labels(seeds, mask, max_iters=64, device=CPU)
        n_ref = TN.propagation_sweeps()
        monkeypatch.setattr(TN, "CHECK_EVERY", check_every)
        got = TN.propagate_labels(seeds, mask, max_iters=64, device=CPU)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(ref.numpy(), want)
        assert TN.propagation_sweeps() == n_ref


def test_label_sizes_matches_jax():
    rng = np.random.default_rng(2)
    labels = rng.integers(0, 9, size=(4, 20, 20)).astype(np.int32)
    want = np.asarray(JN.label_sizes(jnp.asarray(labels), max_labels=6))
    got = TN.label_sizes(labels, max_labels=6, device=CPU)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["isotropic", "anisotropic"])
def test_segment_nuclei_matches_jax(case):
    if case == "isotropic":
        im = _nuclei_image()
        kw = dict(smooth_sigma=2.0, seed_min_distance=15.0,
                  max_num_nuclei=16, min_size_voxels=100, max_iters=64)
    else:
        im, _, px = _touching_scene()
        kw = dict(smooth_sigma=2.0, seed_min_distance=25.0,
                  max_num_nuclei=8, min_size_voxels=100, pixel_sizes=px)
    want = JN.segment_nuclei(jnp.asarray(im), **kw)
    got = TN.segment_nuclei(im, device=CPU, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert len(np.unique(got[0].numpy())) - 1 == (3 if case == "isotropic"
                                                 else 2)


def test_segment_cells_matches_jax():
    dapi, polyt, px = _touching_scene()
    kw = dict(pixel_sizes=px, smooth_sigma=2.0, seed_min_distance=25.0,
              max_num_nuclei=8, min_size_voxels=100)
    want = JN.segment_cells(jnp.asarray(dapi), jnp.asarray(polyt), **kw)
    got = TN.segment_cells(dapi, polyt, device=CPU, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    cells, nuclei = got
    assert (cells > 0).sum() > 1.3 * (nuclei > 0).sum()
    # no polyT: the nuclei twice, as JAX's
    only = TN.segment_cells(dapi, device=CPU, **kw)
    np.testing.assert_array_equal(only[0].numpy(), nuclei.numpy())


@pytest.mark.parametrize("case", ["random", "gaps", "empty"])
def test_label_bboxes_match_numpy(case):
    rng = np.random.default_rng(7)
    labels = rng.integers(0, 5, size=(6, 30, 30)).astype(np.int32)
    if case == "gaps":
        labels[labels == 2] = 0
        labels[3, 4, 5] = 9
    elif case == "empty":
        labels[:] = 0
    want = JN._label_bboxes(labels)
    got = TN._label_bboxes(labels, device=CPU)
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)


def test_shape_ratio_matches_jax():
    xx, yy = np.meshgrid(np.arange(40), np.arange(40), indexing="ij")
    disc = (xx - 20) ** 2 + (yy - 20) ** 2 <= 12 ** 2
    snake = np.zeros((40, 40), bool)
    snake[5, 2:38] = True
    snake[5:20, 37] = True
    for m in (disc, snake, np.zeros((10, 10), bool)):
        assert TN.shape_ratio(torch.from_numpy(m)) == JN.shape_ratio(m)


@pytest.mark.parametrize("case", ["screens", "random"])
def test_screen_labels_matches_jax(case):
    labels = np.zeros((4, 60, 60), np.int32)
    if case == "screens":
        labels[:, 20:32, 20:32] = 1
        labels[:, 40:41, 5:55] = 2
        labels[:, 2:12, 2:12] = 3
        labels[0, 50, 50] = 4
        kw = dict(min_size_voxels=20, min_shape_ratio=0.03,
                  boundary_margin=4)
    else:
        rng = np.random.default_rng(5)
        for l in range(1, 12):
            lo = rng.integers(0, 50, 3)
            labels[lo[0] % 4:, lo[1]:lo[1] + rng.integers(1, 12),
                   lo[2]:lo[2] + rng.integers(1, 12)] = l
        kw = dict(min_size_voxels=30, min_shape_ratio=0.02,
                  boundary_margin=3)
    want = JN.screen_labels(labels, **kw)
    got = TN.screen_labels(labels, device=CPU, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_split_oversized_nuclei_matches_jax():
    shape = (8, 64, 64)
    im = np.asarray(jsyn.render_gaussian_spots(
        shape, np.array([[4.0, 24.0, 32.0], [4.0, 44.0, 32.0]]),
        np.array([2000.0, 2000.0]), np.tile([2.5, 7.0, 7.0], (2, 1)),
        background=60.0), np.float32)
    zz, xx, yy = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    merged = (((xx - 24) ** 2 / 100 + (yy - 32) ** 2 / 100
               + (zz - 4) ** 2 / 9) <= 1.0) \
        | (((xx - 44) ** 2 / 100 + (yy - 32) ** 2 / 100
            + (zz - 4) ** 2 / 9) <= 1.0)
    labels = merged.astype(np.int32)
    labels[:, 2:5, 2:5] = 2                  # small: stays whole
    size = int(merged.sum())
    want = JN.split_oversized_nuclei(im, labels, max_size_voxels=size // 2,
                                     seed_min_distance=10.0)
    got = TN.split_oversized_nuclei(im, labels, max_size_voxels=size // 2,
                                    seed_min_distance=10.0, device=CPU)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) == 4
    # nothing oversized: untouched
    same = TN.split_oversized_nuclei(im, labels, max_size_voxels=10 ** 6,
                                     device=CPU)
    np.testing.assert_array_equal(same.numpy(), labels)


def test_merge_and_interpolate_z_masks_match_jax():
    masks = np.zeros((3, 16, 16), np.int32)
    masks[0, 2:8, 2:8] = 1
    masks[1, 2:8, 2:8] = 2
    masks[2, 3:8, 2:8] = 5
    masks[1, 10:15, 10:15] = 3
    masks[2, 9:12, 6:15] = 7
    for th in (0.5, 0.8, 0.95):
        np.testing.assert_array_equal(
            TN.merge_z_layer_masks(torch.from_numpy(masks), overlap_th=th),
            JN.merge_z_layer_masks(masks, overlap_th=th))
    z_masks = np.stack([np.full((4, 4), 1), np.full((4, 4), 2),
                        np.full((4, 4), 3)])
    z = np.array([0.0, 1.0, 2.0])
    target = np.array([0.0, 0.4, 0.6, 1.9, 2.5, 1.0004])
    np.testing.assert_array_equal(TN.interpolate_z_masks(z_masks, z, target),
                                  JN.interpolate_z_masks(z_masks, z, target))
    with pytest.raises(ValueError, match="unsupported"):
        TN.interpolate_z_masks(z_masks, z, [0.5], mode="linear")


def test_package_exports_every_jax_name():
    assert set(JS.__all__) <= set(TS.__all__)
    for name in JS.__all__:
        assert hasattr(TS, name), name


def test_entry_points_need_a_card_without_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    im = _nuclei_image()
    with pytest.raises(RuntimeError, match="CUDA"):
        TN.segment_nuclei(im)
    with pytest.raises(RuntimeError, match="CUDA"):
        TN.screen_labels(np.zeros((2, 4, 4), np.int32))
