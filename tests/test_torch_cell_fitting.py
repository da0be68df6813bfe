"""PyTorch port vs JAX package: per-cell crop fitting on the CPU.

``segmentation_bounding_boxes``, ``_common_crop_shape`` and the crop
origins equal to JAX's; ``fit_spots_in_crops``, ``fit_spots_by_segmentation``
(also through ``DaxProcesser._fit_spots_by_segmentation`` with a drift) and
``fit_spots_around_centers`` on tests/test_cell_fitting.py's two-nuclei
scene, held at tests/test_torch_fit_entry.py's tolerances (the same valid
spots, centres within 1e-3 px, heights within rtol 1e-2, widths within
1e-3).  The port's kernels run their plain versions on CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageanalysis3_tpu import synthetic as jsyn
from imageanalysis3_tpu.ops import cell_fitting as jcf
from imageanalysis3_tpu_torch.ops import cell_fitting as tcf

torch.set_num_threads(2)

SHAPE = (12, 96, 96)


def _two_nuclei_scene():
    """tests/test_cell_fitting.py's scene: two nucleus boxes with dim
    spots inside, bright clutter outside."""
    labels = np.zeros(SHAPE, np.int32)
    labels[:, 8:40, 8:40] = 1
    labels[:, 56:88, 50:88] = 2
    dim = {1: np.array([[6.0, 20.0, 18.0], [5.0, 30.0, 30.0]]),
           2: np.array([[6.0, 70.0, 60.0], [7.0, 62.0, 78.0]])}
    bright = np.array([[6.0, 20.0, 70.0], [5.0, 44.0, 14.0],
                       [7.0, 44.0, 46.0], [6.0, 88.0, 20.0],
                       [5.0, 70.0, 30.0], [7.0, 30.0, 60.0],
                       [6.0, 10.0, 56.0], [5.0, 86.0, 40.0]])
    centers = np.vstack([dim[1], dim[2], bright])
    heights = np.concatenate([[400.0] * 4, [5000.0] * len(bright)])
    sigmas = np.tile([1.3, 1.8, 1.8], (len(centers), 1))
    im = jsyn.render_gaussian_spots(SHAPE, centers, heights, sigmas,
                                    background=120.0)
    return im.astype(np.float32), labels, dim


@pytest.fixture(scope="module")
def scene():
    return _two_nuclei_scene()


def _assert_fits_close(a, b):
    """test_torch_fit_entry.py's tolerances."""
    np.testing.assert_allclose(a[:, 1:4], b[:, 1:4], atol=1e-3)
    np.testing.assert_allclose(a[:, 0], b[:, 0], rtol=1e-2)
    np.testing.assert_allclose(a[:, 5:8], b[:, 5:8], atol=1e-3)


def _ragged_labels():
    rng = np.random.default_rng(3)
    lab = np.zeros((10, 40, 36), np.int32)
    lab[2:5, 4:10, 6:14] = 1
    lab[1:7, 20:30, 2:12] = 2
    lab[0:10, 30:40, 20:36] = 7
    lab[rng.uniform(size=lab.shape) < 0.002] = 4
    lab[lab.shape[0] // 2, 0, 0] = -3              # negatives are background
    return lab


@pytest.mark.parametrize("pad", [0, 2, 3])
def test_boxes_shape_and_origins_match_jax(scene, pad):
    for lab in (scene[1], _ragged_labels()):
        want = jcf.segmentation_bounding_boxes(lab, pad=pad)
        got = tcf.segmentation_bounding_boxes(lab, pad=pad, device="cpu")
        assert list(got) == list(want)
        for cid in want:
            for a, b in zip(got[cid], want[cid]):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
        cids = sorted(want)
        shape_w = jcf._common_crop_shape([want[c] for c in cids], lab.shape)
        shape_g = tcf._common_crop_shape([got[c] for c in cids], lab.shape)
        assert shape_g == shape_w
    assert tcf.segmentation_bounding_boxes(np.zeros((2, 4, 4), np.int32),
                                           device="cpu") == {}


def test_fit_spots_in_crops_matches_jax(scene):
    im = scene[0]
    # the last two origins lie partly outside and are clamped
    origins = np.array([[0, 4, 4], [0, 52, 46], [3, 90, -10], [-2, -5, 70]],
                       np.int32)
    kw = dict(max_num_seeds=8, th_seed=250.0)
    sj, vj = jcf.fit_spots_in_crops(jnp.asarray(im), jnp.asarray(origins),
                                    (12, 40, 40), **kw)
    st, vt = tcf.fit_spots_in_crops(im, origins, (12, 40, 40),
                                    device="cpu", **kw)
    vj = np.asarray(vj)
    assert vj.sum() >= 8
    np.testing.assert_array_equal(vt.numpy(), vj)
    _assert_fits_close(st.numpy()[vj], np.asarray(sj)[vj])


@pytest.mark.parametrize("drift", [None, (0.0, 1.5, -2.0)])
def test_fit_spots_by_segmentation_matches_jax(scene, drift):
    im, labels, dim = scene
    kw = dict(th_seed=250.0, num_spots=8)
    sj, cj = jcf.fit_spots_by_segmentation(im, labels, drift=drift, **kw)
    st, ct = tcf.fit_spots_by_segmentation(
        torch.from_numpy(im), torch.from_numpy(labels),
        drift=None if drift is None else torch.tensor(drift,
                                                      dtype=torch.float32),
        **kw)
    assert st.dtype == torch.float32 and ct.dtype == torch.int32
    np.testing.assert_array_equal(ct.numpy(), cj)
    _assert_fits_close(st.numpy(), sj)
    if drift is None:
        # every dim nuclear spot is found in its own cell (the JAX test)
        for cid, centers in dim.items():
            mine = st.numpy()[ct.numpy() == cid][:, 1:4]
            for c in centers:
                assert np.linalg.norm(mine - c, axis=1).min() < 0.3


def test_dax_processer_fit_spots_by_segmentation(scene):
    """The DaxProcesser step: its `drift` moves the boxes, its results are
    stored as spots_<ch> / spots_cell_ids_<ch>."""
    from imageanalysis3_tpu_torch.pipeline import DaxProcesser

    im, labels, _ = scene
    proc = DaxProcesser("unused.dax", correction_channels=["750"],
                        all_channels=["750"], single_im_size=SHAPE,
                        device="cpu")
    proc.ims = {"750": torch.from_numpy(im)}
    proc.drift = torch.tensor([0.0, -1.0, 2.5])
    spots, ids = proc._fit_spots_by_segmentation("750", labels,
                                                 th_seed=250.0, num_spots=8)
    sj, cj = jcf.fit_spots_by_segmentation(
        im, labels, th_seed=250.0, num_spots=8,
        drift=np.asarray([0.0, -1.0, 2.5], np.float32))
    assert proc.spots_750 is spots and proc.spots_cell_ids_750 is ids
    np.testing.assert_array_equal(ids.numpy(), cj)
    _assert_fits_close(spots.numpy(), sj)


def test_fit_spots_around_centers_matches_jax(scene):
    im = scene[0]
    centers = np.array([[6.0, 25.0, 24.0], [6.0, 66.0, 69.0]])
    kw = dict(crop_size=(12, 32, 32), th_seed=250.0, max_num_seeds=8)
    sj, vj = jcf.fit_spots_around_centers(im, centers, **kw)
    st, vt = tcf.fit_spots_around_centers(im, centers, device="cpu", **kw)
    np.testing.assert_array_equal(vt.numpy(), vj)
    _assert_fits_close(st.numpy()[vj], sj[vj])
