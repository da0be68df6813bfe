"""PyTorch port vs JAX package: domain calling on the CPU.

Planted block polymers (dense random-walk blocks joined by jumps, 10 % of
the regions missing) go through both packages.  ``sliding_window_dist``
(float32) is held at rtol 1e-5 / atol 1e-5 for every metric, and each
slice of a batch equals its map alone; every discrete output (peaks,
candidate and called starts, merges, outlier removal, matched starts) is
held equal; float64 outputs (domain distances, the arrowhead transform,
neighbour distances, KS / t-test statistics) at rtol 1e-10.
``find_peaks_1d`` breaks equal scores by the lower index, as XLA's top-k.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageanalysis3_tpu.analysis import domains as jd
from imageanalysis3_tpu_torch.analysis import domains as td

torch.set_num_threads(2)

F32 = dict(rtol=1e-5, atol=1e-5)
F64 = dict(rtol=1e-10, atol=1e-12)
SIZES = [14, 12, 16, 9]


def _polymer(seed, sizes=SIZES, missing=0.1, step=80.0, jump=900.0):
    """Dense blocks separated by large jumps (clear domains), in nm."""
    rng = np.random.default_rng(seed)
    pts, origin = [], np.zeros(3)
    for s in sizes:
        blk = origin + np.cumsum(rng.normal(0, step / np.sqrt(3), (s, 3)), 0)
        pts.append(blk)
        origin = (blk[-1] + rng.normal(0, jump / np.sqrt(3), 3)
                  + np.array([jump, 0, 0]))
    z = np.concatenate(pts)
    z[rng.uniform(size=len(z)) < missing] = np.nan
    return z


def _dm(z):
    return np.linalg.norm(z[:, None] - z[None], axis=-1)


@pytest.mark.parametrize("metric,window", [("median", 5), ("mean", 4),
                                           ("insulation", 6),
                                           ("normed_insulation", 5)])
def test_sliding_window_dist_matches_jax(metric, window):
    z = _polymer(0)
    valid = np.isfinite(z).all(1)
    want = np.asarray(jd.sliding_window_dist(
        jnp.asarray(_dm(z)), window, metric, jnp.asarray(valid)))
    got = td.sliding_window_dist(_dm(z), window, metric, valid,
                                 device="cpu").numpy()
    np.testing.assert_allclose(got, want, **F32)


def test_sliding_window_dist_batched_slices():
    maps = np.stack([_dm(_polymer(s)) for s in range(3)])
    batch = td.sliding_window_dist(maps, 5, device="cpu")
    for k in range(3):
        assert torch.equal(batch[k], td.sliding_window_dist(maps[k], 5,
                                                            device="cpu"))


def test_find_peaks_1d_ties_and_batch():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 60)).astype(np.float32)
    x[0, 10] = x[0, 12] = x[0, 30] = 5.0      # equal peaks, one suppressed
    x[1, 20:23] = [1.0, 4.0, 1.0]
    for distance, max_peaks in [(3, 16), (5, 64), (1, 8)]:
        b_idx, b_ok = td.find_peaks_1d(x, distance=distance,
                                       max_peaks=max_peaks, device="cpu")
        for k in range(3):
            j_idx, j_ok = jd.find_peaks_1d(jnp.asarray(x[k]),
                                           distance=distance,
                                           max_peaks=max_peaks)
            np.testing.assert_array_equal(b_ok[k].numpy(), np.asarray(j_ok))
            np.testing.assert_array_equal(b_idx[k].numpy()[b_ok[k].numpy()],
                                          np.asarray(j_idx)[np.asarray(j_ok)])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_candidates_basic_and_iterative_calling_match_jax(seed):
    z = _polymer(seed)
    np.testing.assert_array_equal(
        td.candidate_domain_boundaries(z, device="cpu"),
        jd.candidate_domain_boundaries(z))
    np.testing.assert_array_equal(td.basic_domain_calling(z, device="cpu"),
                                  jd.basic_domain_calling(z))
    np.testing.assert_array_equal(
        td.iterative_domain_calling(z, dist_th=1.0, device="cpu"),
        jd.iterative_domain_calling(z, dist_th=1.0))


def test_domain_pdists_and_merge_match_jax():
    z = _polymer(3)
    starts = [0, 5, 14, 20, 26, 42, 47]
    np.testing.assert_allclose(td.domain_pdists(z, starts,
                                                device="cpu").numpy(),
                               jd.domain_pdists(z, starts), **F64)
    for th in (0.65, 2.0, 10.0):
        np.testing.assert_array_equal(
            td.merge_domains(z, starts, dist_th=th, device="cpu"),
            jd.merge_domains(z, starts, dist_th=th))
    dm = _dm(z)
    assert td.domain_segment_distance(dm, (0, 14), (14, 26), device="cpu") \
        == pytest.approx(jd.domain_segment_distance(dm, (0, 14), (14, 26)),
                         rel=1e-10)


def test_arrowhead_transform_matches_jax():
    dm = _dm(_polymer(4))
    np.testing.assert_allclose(td.arrowhead_transform(dm,
                                                      device="cpu").numpy(),
                               jd.arrowhead_transform(dm), **F64)


@pytest.mark.parametrize("kw", [{}, {"window_size": 6},
                                {"use_distance": False}])
def test_insulation_domain_calling_matches_jax(kw):
    dm = _dm(_polymer(5, sizes=[15, 15, 12]))
    np.testing.assert_array_equal(
        td.insulation_domain_calling(dm, device="cpu", **kw),
        jd.insulation_domain_calling(dm, **kw))


@pytest.mark.parametrize("square", [False, True])
def test_sliding_window_domain_calling_matches_jax(square):
    z = _polymer(6)
    coords = _dm(z) if square else z
    got = td.sliding_window_domain_calling(coords, return_strength=True,
                                           device="cpu")
    want = jd.sliding_window_domain_calling(coords, return_strength=True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_neighboring_distance_matches_jax():
    z = _polymer(7)
    np.testing.assert_allclose(td.neighboring_distance(z, 4,
                                                       device="cpu").numpy(),
                               jd.neighboring_distance(z, 4), **F64)


def test_contact_correlation_calling_matches_jax():
    z = _polymer(8)
    z[[5, 33]] += 3000.0                      # two outlier loci
    for kw in ({}, {"contact_th": 400.0, "corr_th": 0.3}):
        np.testing.assert_array_equal(
            td.contact_correlation_domain_calling(z, device="cpu", **kw),
            jd.contact_correlation_domain_calling(z, **kw))
    np.testing.assert_array_equal(
        td.merge_domain_by_contact_correlation(z, [5, 14, 26], 600.0, 0.2,
                                               device="cpu"),
        jd.merge_domain_by_contact_correlation(z, [5, 14, 26], 600.0, 0.2))


def test_find_matched_starts_matches_jax():
    starts, ref = [0, 13, 15, 27, 44], [0, 14, 26, 42]
    for ignore in (True, False):
        np.testing.assert_array_equal(
            td.find_matched_starts(starts, ref, 5, ignore),
            jd.find_matched_starts(starts, ref, 5, ignore))


@pytest.mark.parametrize("method", ["ks", "ttest"])
def test_domain_stats_match_jax(method):
    z = _polymer(9)
    dm = _dm(z)
    norm = 1.0 + np.abs(np.arange(len(z))[:, None] - np.arange(len(z)))
    for coords in (z, dm):
        got = td.domain_stat(coords, (0, 14), (14, 26), method=method,
                             device="cpu")
        want = jd.domain_stat(coords, (0, 14), (14, 26), method=method)
        np.testing.assert_allclose(got, want, **F64)
    got = td.domain_stat(dm, (0, 14), (14, 26), method=method,
                         normalization_mat=norm, return_pval=False,
                         device="cpu")
    assert got == pytest.approx(jd.domain_stat(
        dm, (0, 14), (14, 26), method=method, normalization_mat=norm,
        return_pval=False), rel=1e-10)
    starts = [0, 14, 26, 42]
    for local in (True, False):
        got = td.domain_neighboring_stats(z, starts, method=method,
                                          use_local=local, device="cpu")
        want = jd.domain_neighboring_stats(z, starts, method=method,
                                           use_local=local)
        np.testing.assert_allclose(got, want, **F64)
    with pytest.raises(ValueError):
        td.domain_stat(z, (0, 5), (5, 9), method="other", device="cpu")
