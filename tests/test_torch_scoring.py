"""PyTorch port vs JAX package: spot scoring (local centres, reference
statistics, the linear E-step scores, the CDF family and the decoders'
CDF log odds) on seeded traces and candidate tables.

Tolerances: rtol 1e-4 / atol 1e-4; ``chromosomal_spot_scores`` 1e-3 /
2e-3 (tests/test_cdf_scoring.py's).  Medians average the two middle
values as ``jnp.nanmedian`` does: the even-count cases below fail with
``torch.nanmedian``'s lower median."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from imageanalysis3_tpu.decode import scoring as js
from imageanalysis3_tpu_torch.decode import scoring as ts
from imageanalysis3_tpu_torch.ops.filters import nanquantile

torch.set_num_threads(2)
PX = np.array([200.0, 108.0, 108.0])
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _trace(seed, r=20, p_valid=0.8):
    """(sel (R, 11), sel_valid (R,)): a random-walk trace in px."""
    rng = np.random.default_rng(seed)
    sel = np.zeros((r, 11), np.float32)
    sel[:, 1:4] = np.cumsum(rng.normal(0, 2.0, (r, 3)), 0) + 50
    sel[:, 0] = rng.uniform(500, 1500, r)
    return sel, rng.uniform(size=r) < p_valid


def _table(seed, sel, m=4):
    rng = np.random.default_rng(seed + 100)
    r = len(sel)
    cand = np.zeros((r, m, 11), np.float32)
    cand[..., 1:4] = sel[:, None, 1:4] + rng.normal(0, 3.0, (r, m, 3))
    cand[..., 0] = rng.uniform(300, 2000, (r, m))
    return cand, rng.uniform(size=(r, m)) > 0.3


def test_averaging_median_where_torch_takes_the_lower():
    x = np.asarray([1.0, 2.0, 3.0, 4.0, np.nan], np.float32)
    assert float(nanquantile(torch.from_numpy(x), 0.5)) == 2.5
    assert float(jnp.nanmedian(jnp.asarray(x))) == 2.5
    assert float(torch.nanmedian(torch.from_numpy(x))) == 2.0


@pytest.mark.parametrize("local_size", [3, 5, 7])
def test_local_centers_and_neighboring_dists_match_jax(local_size):
    """Single traces and a batch of three, each row equal to its own call."""
    rng = np.random.default_rng(local_size)
    z = rng.normal(size=(3, 15, 3)).astype(np.float32)
    v = rng.uniform(size=(3, 15)) > 0.3
    c_t, h_t = ts.local_centers(*_t(z, v), local_size)
    n_t, ok_t = ts.neighboring_dists(*_t(z, v))
    for k in range(3):
        c_j, h_j = js.local_centers(*_j(z[k], v[k]), local_size)
        n_j, ok_j = js.neighboring_dists(*_j(z[k], v[k]))
        np.testing.assert_array_equal(h_t[k].numpy(), np.asarray(h_j))
        np.testing.assert_array_equal(ok_t[k].numpy(), np.asarray(ok_j))
        _close(c_t[k], c_j, rtol=1e-6, atol=1e-6)
        _close(n_t[k], n_j, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed,with_center", [(0, False), (1, True),
                                              (2, False)])
def test_chromosome_ref_stats_match_jax(seed, with_center):
    """Seed 0 has an even count of valid regions, so its medians average
    two values."""
    sel, ok = _trace(seed)
    if seed == 0:
        ok[:] = True
        ok[[3, 9]] = False
        assert ok.sum() % 2 == 0
    if seed == 2:
        ok[:] = False                       # every default
    ctr = np.asarray([11.0, 48.0, 52.0], np.float32) if with_center else None
    got = ts.chromosome_ref_stats(*_t(sel, ok), None if ctr is None
                                  else torch.from_numpy(ctr))
    want = js.chromosome_ref_stats(*_j(sel, ok), None if ctr is None
                                   else jnp.asarray(ctr))
    for g, w in zip(got, want):
        _close(g, w)


def test_linear_and_intensity_scores_match_jax():
    rng = np.random.default_rng(3)
    d = rng.uniform(0, 5000, 50).astype(np.float32)
    i = rng.uniform(-100, 3000, 50).astype(np.float32)
    _close(ts.linear_distance_score(torch.from_numpy(d), 700.0, 2.0, 3000.0),
           js.linear_distance_score(jnp.asarray(d), 700.0, 2.0, 3000.0))
    _close(ts.intensity_score(torch.from_numpy(i), 900.0, 1.5),
           js.intensity_score(jnp.asarray(i), 900.0, 1.5))


@pytest.mark.parametrize("with_center", [False, True])
def test_score_candidates_match_jax(with_center):
    """Scores of a table against two traces in one batch, each equal to
    JAX's call on its own trace."""
    traces = [_trace(4), _trace(5)]
    cand, valid = _table(4, traces[0][0])
    ctr = (np.asarray([[11.0, 48.0, 52.0], [9.0, 50.0, 47.0]], np.float32)
           if with_center else None)
    sel = np.stack([t[0] for t in traces])
    ok = np.stack([t[1] for t in traces])
    got = ts.score_candidates(*_t(cand, valid, sel, ok),
                              None if ctr is None else torch.from_numpy(ctr))
    for k in range(2):
        want = js.score_candidates(*_j(cand, valid, sel[k], ok[k]),
                                   None if ctr is None
                                   else jnp.asarray(ctr[k]))
        _close(got[k], want)


def test_radius_of_gyration_and_sort_ref_values_match_jax():
    rng = np.random.default_rng(6)
    z = rng.normal(0, 500, (40, 3)).astype(np.float32)
    z[3] = np.nan
    v = rng.uniform(size=40) > 0.2
    _close(ts.radius_of_gyration(torch.from_numpy(z)),
           js.radius_of_gyration(jnp.asarray(z)))
    _close(ts.radius_of_gyration(*_t(z, v)),
           js.radius_of_gyration(*_j(z, v)))
    vals = z[:, 0]
    for valid in (None, v):
        got = ts.sort_ref_values(*_t(vals, *([] if valid is None
                                              else [valid])))
        want = js.sort_ref_values(*_j(vals, *([] if valid is None
                                               else [valid])))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert int(got[1]) == int(want[1]) and got[1].dtype == torch.int32


@pytest.mark.parametrize("vmin,vmax", [(-np.inf, np.inf), (5.0, 40.0),
                                       (0.0, 0.0)])
def test_cum_prob_and_cdf_scores_match_jax(vmin, vmax):
    """Targets with NaN, +-inf, ties with the reference and values outside
    its range; an empty window (vmin == vmax)."""
    rng = np.random.default_rng(7)
    ref = rng.uniform(0, 50, 61).astype(np.float32)
    ref[::7] = np.nan
    row_t, cnt_t = ts.sort_ref_values(torch.from_numpy(ref))
    row_j, cnt_j = js.sort_ref_values(jnp.asarray(ref))
    t = rng.uniform(-10, 60, 40).astype(np.float32)
    t[:4] = [np.nan, np.inf, -np.inf, ref[1]]
    _close(ts.cum_prob(row_t, cnt_t, torch.from_numpy(t), vmin, vmax),
           js.cum_prob(row_j, cnt_j, jnp.asarray(t), vmin, vmax))
    _close(ts.cdf_distance_score(torch.from_numpy(t), row_t, cnt_t, 1.5,
                                 (vmin, vmax)),
           js.cdf_distance_score(jnp.asarray(t), row_j, cnt_j, 1.5,
                                 (vmin, vmax)))
    _close(ts.cdf_intensity_score(torch.from_numpy(t), row_t, cnt_t, 1.5,
                                  max(vmin, 0.0)),
           js.cdf_intensity_score(jnp.asarray(t), row_j, cnt_j, 1.5,
                                  max(vmin, 0.0)))


@pytest.mark.parametrize("seed", [8, 9])
def test_chromosome_ref_arrays_and_neighbor_dists_match_jax(seed):
    sel, ok = _trace(seed, r=16)
    cand, valid = _table(seed, sel)
    valid[5] = False
    got = ts.chromosome_ref_arrays(*_t(sel, ok), intensity_th=600.0)
    want = js.chromosome_ref_arrays(*_j(sel, ok), intensity_th=600.0)
    for g, w in zip(got, want):
        _close(g, w)
    z = np.where(valid[..., None], cand[..., 1:4] * PX.astype(np.float32),
                 np.nan).astype(np.float32)
    _close(ts.candidate_neighbor_dists(*_t(z, valid)),
           js.candidate_neighbor_dists(*_j(z, valid)))


@pytest.mark.parametrize("seed,with_center", [(10, False), (11, True)])
def test_chromosomal_spot_scores_match_jax(seed, with_center):
    sel, ok = _trace(seed, r=24)
    cand, valid = _table(seed, sel, m=3)
    ctr = np.asarray([11.0, 48.0, 52.0], np.float32) if with_center else None
    kw = dict(local_size=5, intensity_th=1.0)
    got = ts.chromosomal_spot_scores(
        *_t(cand, valid, sel, ok),
        None if ctr is None else torch.from_numpy(ctr), **kw,
        return_separate=True)
    want = js.chromosomal_spot_scores(
        *_j(cand, valid, sel, ok),
        None if ctr is None else jnp.asarray(ctr), **kw,
        return_separate=True)
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-3, atol=2e-3)
    _close(ts.chromosomal_spot_scores(*_t(cand, valid, sel, ok), **kw),
           js.chromosomal_spot_scores(*_j(cand, valid, sel, ok), **kw),
           rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("with_negative", [False, True])
def test_generate_cdf_scores_match_jax(with_negative):
    """NaN values rank past every reference entry, as in JAX."""
    rng = np.random.default_rng(12)
    pos = rng.uniform(0, 10, 53).astype(np.float32)
    pos[::9] = np.nan
    neg = rng.uniform(5, 15, 31).astype(np.float32)
    vals = rng.uniform(-1, 16, 25).astype(np.float32)
    vals[[0, 5]] = np.nan
    pr_t, pc_t = ts.sort_ref_values(torch.from_numpy(pos))
    pr_j, pc_j = js.sort_ref_values(jnp.asarray(pos))
    extra_t, extra_j = [], []
    if with_negative:
        extra_t = list(ts.sort_ref_values(torch.from_numpy(neg)))
        extra_j = list(js.sort_ref_values(jnp.asarray(neg)))
    got = ts.generate_cdf_scores(torch.from_numpy(vals), pr_t, pc_t,
                                 *extra_t)
    want = js.generate_cdf_scores(jnp.asarray(vals), pr_j, pc_j, *extra_j)
    _close(got, want)
    assert np.isfinite(got.numpy()[0])


@pytest.mark.parametrize("method,with_valid", [("median", True),
                                               ("median", False),
                                               ("mean", True)])
def test_distance_scores_and_normalize_intensities_match_jax(method,
                                                             with_valid):
    """Six valid heights: the median averages the middle two."""
    v = np.array([0.0, 500.0, 2000.0, 4000.0], np.float32)
    _close(ts.log_distance_scores(v), js.log_distance_scores(v))
    _close(ts.exp_distance_scores(v), js.exp_distance_scores(v))
    rng = np.random.default_rng(13)
    spots = rng.uniform(0, 5, (8, 11)).astype(np.float32)
    spots[:, 0] = [10, 20, 35, 40, 55, 60, 90, 7]
    ok = np.array([1, 1, 1, 1, 1, 1, 0, 0], bool)
    extra = [ok] if with_valid else []
    got = ts.normalize_intensities(*_t(spots, spots[:, 0], *extra),
                                   method=method)
    want = js.normalize_intensities(*_j(spots, spots[:, 0], *extra),
                                    method=method)
    _close(got, want, rtol=1e-6, atol=1e-6)
