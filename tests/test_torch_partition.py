"""PyTorch port vs JAX package: spot partitioning on the CPU.

``spots_to_labels`` (the mode vote, its tie to the smallest label, rounding
half to even, the chunking over spots), ``spots_to_intensity``,
``find_coordinate_intensities``, ``count_genes`` and the rigid
nearest-neighbour warps ``translate_label_image`` / ``translate_volume``,
each held EQUAL to the JAX function on the same seeded inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageanalysis3_tpu.analysis import partition as jp
from imageanalysis3_tpu_torch.analysis import partition as tp

torch.set_num_threads(2)


def _labels(shape=(12, 48, 48), seed=0):
    """Blocks of cells 1-4 plus a speckle of random labels, so cubes see
    several labels at once."""
    rng = np.random.default_rng(seed)
    lab = np.zeros(shape, np.int32)
    lab[:, 4:20, 4:22] = 1
    lab[:, 24:44, 6:30] = 2
    lab[2:9, 8:30, 28:44] = 3
    lab[:, 30:46, 32:46] = 4
    speck = rng.uniform(size=shape) < 0.05
    lab[speck] = rng.integers(1, 7, speck.sum())
    return lab


def _coords(n, shape, seed=1):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-3, np.asarray(shape) + 2, (n, 3)).astype(np.float32)
    # exact halves: half-to-even rounding must agree
    c[:8] = np.floor(c[:8]) + 0.5
    return c


@pytest.mark.parametrize("radius", [1, 3, 10])
def test_spots_to_labels_matches_jax(radius):
    lab = _labels()
    coords = _coords(200, lab.shape)
    valid = np.random.default_rng(2).uniform(size=200) > 0.1
    want = np.asarray(jp.spots_to_labels(jnp.asarray(lab),
                                         jnp.asarray(coords),
                                         jnp.asarray(valid),
                                         search_radius=radius))
    got = tp.spots_to_labels(lab, coords, valid, search_radius=radius,
                             device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[~valid] == -1).all() and (want[valid] > 0).any()


def test_spots_to_labels_tie_breaks_to_the_smallest_label():
    """Two labels with equal counts in the cube: the smaller one wins (JAX
    sorts, then takes the first maximum), whichever lies first in space.
    The spot at y = 1.5 rounds (half to even) to 2, so its 3^3 cube spans
    y = 1..3 and sees one plane of each label."""
    coords = np.array([[1.0, 1.0, 1.5]], np.float32)
    for first, second in ((9, 3), (3, 9)):
        lab = np.zeros((3, 3, 4), np.int32)
        lab[:, :, 1] = first
        lab[:, :, 3] = second
        want = np.asarray(jp.spots_to_labels(jnp.asarray(lab),
                                             jnp.asarray(coords),
                                             jnp.ones(1, bool),
                                             search_radius=1))
        got = tp.spots_to_labels(torch.from_numpy(lab),
                                 torch.from_numpy(coords),
                                 torch.ones(1, dtype=torch.bool),
                                 search_radius=1)
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(got[0]) == 3


def test_spots_to_labels_chunks(monkeypatch):
    """Chunked over spots (a chunk of 3 spots here) it gives the same."""
    lab = _labels()
    coords = _coords(50, lab.shape, seed=5)
    valid = np.ones(50, bool)
    whole = tp.spots_to_labels(lab, coords, valid, search_radius=2,
                               device="cpu")
    monkeypatch.setattr(tp, "_CHUNK_ELEMENTS", 3 * 125)
    chunked = tp.spots_to_labels(lab, coords, valid, search_radius=2,
                                 device="cpu")
    assert torch.equal(whole, chunked)


@pytest.mark.parametrize("radius", [2, 5])
def test_intensities_match_jax(radius):
    rng = np.random.default_rng(3)
    im = rng.uniform(0, 1000, (10, 40, 36)).astype(np.float32)
    coords = _coords(120, im.shape, seed=4)
    valid = rng.uniform(size=120) > 0.2
    want = np.asarray(jp.spots_to_intensity(jnp.asarray(im),
                                            jnp.asarray(coords),
                                            jnp.asarray(valid),
                                            search_radius=radius))
    got = tp.spots_to_intensity(im, coords, valid, search_radius=radius,
                                device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    want_c = np.asarray(jp.find_coordinate_intensities(
        jnp.asarray(im), jnp.asarray(coords), search_radius=radius))
    got_c = tp.find_coordinate_intensities(im, coords, search_radius=radius,
                                           device="cpu").numpy()
    assert got_c.shape == want_c.shape == (120, (2 * radius + 1) ** 3)
    np.testing.assert_array_equal(got_c, want_c)


def test_count_genes_matches_jax():
    rng = np.random.default_rng(6)
    per_bit = {b: rng.integers(-1, 9, rng.integers(0, 40))
               for b in (3, 1, 7, 2)}
    per_bit[5] = np.zeros(0, np.int64)
    want = jp.count_genes(per_bit)
    got = tp.count_genes({b: torch.from_numpy(v) for b, v in per_bit.items()})
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("angle,drift", [
    (0.0, (0.0, 0.0, 0.0)), (0.0, (0.0, 3.0, -2.0)),
    (0.3, (1.0, 2.25, -1.75)), (-1.1, (-2.0, -4.5, 3.0))])
def test_translate_matches_jax(angle, drift):
    lab = _labels((8, 40, 44), seed=7)
    rot = np.array([[np.cos(angle), -np.sin(angle)],
                    [np.sin(angle), np.cos(angle)]], np.float32)
    want = np.asarray(jp.translate_label_image(jnp.asarray(lab),
                                               jnp.asarray(rot),
                                               jnp.asarray(drift)))
    got = tp.translate_label_image(lab, rot, np.asarray(drift),
                                   device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    im = np.random.default_rng(8).uniform(0, 1e3, lab.shape).astype(
        np.float32)
    want_v = np.asarray(jp.translate_volume(jnp.asarray(im),
                                            jnp.asarray(rot),
                                            jnp.asarray(drift)))
    got_v = tp.translate_volume(torch.from_numpy(im), torch.from_numpy(rot),
                                torch.tensor(drift)).numpy()
    np.testing.assert_array_equal(got_v, want_v)


def test_entry_points_need_a_card_without_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.spots_to_labels(np.zeros((2, 2, 2), np.int32),
                           np.zeros((1, 3), np.float32), np.ones(1, bool))
