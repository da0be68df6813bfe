"""PyTorch port vs JAX package: structure analysis on the CPU, and the
package-level names.

Planted traces of compact domain blocks, some of them meeting in space
away from their chain neighbours, go through both packages: contact maps
and contact frequencies exactly, loop-out scores and the likelihood
matrix (float64) at rtol 1e-10, interaction pairs and loop-outs equal;
the median and centroid summaries at rtol 1e-10; the percentile rule
equal to ``np.percentile``.  The package-level ``contact_map`` and
``normalize_center_spots`` carry the JAX package's meanings (the
structure map of one distance map; the postanalysis standardisation).
"""

import numpy as np
import pytest
import torch

import imageanalysis3_tpu.analysis as ja
import imageanalysis3_tpu_torch.analysis as ta
from imageanalysis3_tpu.analysis import structure as js
from imageanalysis3_tpu_torch.analysis import structure as ts

torch.set_num_threads(2)

F64 = dict(rtol=1e-10, atol=1e-12)
STARTS = [0, 12, 22, 34, 44]


def _blocks(seed, centers=((0, 0, 0), (2000, 0, 0), (150, 120, 0),
                           (2000, 2000, 0), (0, 2000, 100)),
            sizes=(12, 10, 12, 10, 12), spread=160.0, missing=0.08):
    """Compact blocks around given centres (nm): blocks 0 and 2 meet."""
    rng = np.random.default_rng(seed)
    z = np.concatenate([np.asarray(c, float) + rng.normal(0, spread, (s, 3))
                        for c, s in zip(centers, sizes)])
    z[rng.uniform(size=len(z)) < missing] = np.nan
    return z


def _dm(z):
    return np.linalg.norm(z[:, None] - z[None], axis=-1)


def test_package_contact_map_is_the_structure_map():
    dm = _dm(_blocks(0))
    want = ja.contact_map(dm, 300.0)
    got = ta.contact_map(dm, 300.0, device="cpu")
    assert got.shape == want.shape == dm.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_package_normalize_center_spots_is_the_postanalysis_one():
    rng = np.random.default_rng(1)
    spots = rng.normal(0, 5, (30, 11))
    spots[4, 2] = np.nan
    want = ja.normalize_center_spots(spots)
    got = ta.normalize_center_spots(spots, device="cpu").numpy()
    assert got.shape == want.shape == spots.shape
    np.testing.assert_allclose(got, want, **F64)


@pytest.mark.parametrize("th", [300.0, 700.0])
def test_contact_map_and_domain_contact_freq_match_jax(th):
    dm = _dm(_blocks(2))
    np.testing.assert_array_equal(ts.contact_map(dm, th,
                                                 device="cpu").numpy(),
                                  js.contact_map(dm, th))
    np.testing.assert_allclose(ts.domain_contact_freq(dm, STARTS, th,
                                                      device="cpu").numpy(),
                               js.domain_contact_freq(dm, STARTS, th), **F64)


@pytest.mark.parametrize("exclude", [True, False])
def test_inter_domain_interactions_match_jax(exclude):
    dm = _dm(_blocks(3))
    got = ts.inter_domain_interactions(dm, STARTS, 0.55, exclude,
                                       device="cpu")
    assert got == js.inter_domain_interactions(dm, STARTS, 0.55, exclude)
    assert (0, 2) in got


@pytest.mark.parametrize("window", [5, 4])
def test_loop_out_scores_and_calls_match_jax(window):
    z = _blocks(4)
    z[38:43] = z[0:5] + 30.0                 # regions 38-42 loop into block 0
    dm = _dm(z)
    np.testing.assert_allclose(ts.loop_out_scores(dm, STARTS, window,
                                                  device="cpu").numpy(),
                               js.loop_out_scores(dm, STARTS, window), **F64)
    got = ts.call_loop_outs(dm, STARTS, 0.0, window, device="cpu")
    assert got == js.call_loop_outs(dm, STARTS, 0.0, window)
    assert any(dom == 0 and 38 <= pos <= 42 for pos, dom in got)


def test_genome_distance_summary_matches_jax():
    rng = np.random.default_rng(5)
    chrs = {c: rng.normal(0, 1000, (6, n, 3)) for c, n in
            (("1", 8), ("2", 5), ("X", 4))}
    chrs["1"][0, 2] = np.nan
    chrs["2"][3] = np.nan
    got_intra, got_inter = ts.genome_distance_summary(chrs, device="cpu")
    want_intra, want_inter = js.genome_distance_summary(chrs)
    for c in chrs:
        np.testing.assert_allclose(got_intra[c].numpy(), want_intra[c], **F64)
    assert got_inter.keys() == want_inter.keys()
    for k in want_inter:
        assert got_inter[k] == pytest.approx(want_inter[k], rel=1e-10)


@pytest.mark.parametrize("pairs,kw", [([(0, 2)], {}),
                                      ([(0, 2), (1, 3)], {"w_intra": 0.0}),
                                      ([(0, 3)], {"exclude_neighbors": False,
                                                  "normalize": False})])
def test_interdomain_likelihood_matches_jax(pairs, kw):
    dm = _dm(_blocks(6))
    got = ts.interdomain_likelihood(dm, STARTS, pairs, device="cpu", **kw)
    want = js.interdomain_likelihood(dm, STARTS, pairs, **kw)
    np.testing.assert_allclose(got.numpy(), want, **F64)


def test_percentile_follows_numpy():
    rng = np.random.default_rng(7)
    for n in (1, 2, 7, 40):
        x = rng.normal(size=n)
        for q in (0.0, 1.0, 37.5, 50.0, 99.0, 100.0):
            assert ts._percentile(torch.as_tensor(x), q) == np.percentile(x, q)


@pytest.mark.parametrize("seed,kw", [(8, {}), (9, {"init_th": 1.0}),
                                     (10, {"exclude_neighbors": False,
                                           "contact_th": 400.0})])
def test_iterative_interdomain_calling_matches_jax(seed, kw):
    z = _blocks(seed, centers=((0, 0, 0), (2000, 0, 0), (150, 120, 0),
                               (2000, 2000, 0), (0, 2000, 100),
                               (2100, 100, 0), (0, 2100, 0)),
                sizes=(8, 8, 8, 8, 8, 8, 8))
    dm = _dm(z)
    starts = list(range(0, 56, 8))
    got = ts.iterative_interdomain_calling(dm, starts, device="cpu", **kw)
    want = js.iterative_interdomain_calling(dm, starts, **kw)
    assert got == want
    assert len(want) > 0
