"""PyTorch port vs JAX package: population-reference picking (intensity
picks, centre and local-centre distances, pooled references, exact-rank
CDFs, score picks, the EM loop, pick differences and the RNA screen) on
seeded planted populations (polymer traces at 30 nm jitter among decoys,
as tests/test_population_picking.py plants them).

Tolerances: scores rtol 1e-3 / atol 2e-3, reference rows rtol 1e-4 /
atol 1e-2 (the JAX tests'); picks and iteration counts equal on clear
margins."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from imageanalysis3_tpu.decode import population_picking as jpp
from imageanalysis3_tpu_torch.decode import population_picking as tpp

torch.set_num_threads(2)
CPU = {"device": "cpu"}
SCORES = dict(rtol=1e-3, atol=2e-3)
ROWS = dict(rtol=1e-4, atol=1e-2)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _population(seed, n_chr=6, n_regions=30, max_cands=6, drop_frac=0.1,
                decoy_bright=True):
    """(cand (N, R, C, 4) nm, valid, ids, truth zxy, truth slot)."""
    rng = np.random.default_rng(seed)
    cand = np.full((n_chr, n_regions, max_cands, 4), np.nan, np.float32)
    valid = np.zeros((n_chr, n_regions, max_cands), bool)
    truth = np.zeros((n_chr, n_regions, 3))
    truth_idx = np.full((n_chr, n_regions), -1, np.int64)
    for ci in range(n_chr):
        steps = rng.normal(0, 300.0 / np.sqrt(3), (n_regions, 3))
        zxys = rng.uniform(3000, 9000, 3) + np.cumsum(steps, axis=0)
        truth[ci] = zxys
        center = zxys.mean(0)
        for ri in range(n_regions):
            if rng.uniform() < drop_frac:
                continue
            n_c = rng.integers(1, max_cands + 1)
            slot = rng.integers(0, n_c)
            truth_idx[ci, ri] = slot
            for j in range(n_c):
                if j == slot:
                    pos, h = zxys[ri] + rng.normal(0, 30.0, 3), \
                        rng.uniform(800, 1500)
                else:
                    pos = center + rng.normal(0, 3500.0, 3)
                    h = (rng.uniform(800, 2500) if decoy_bright
                         else rng.uniform(300, 900))
                cand[ci, ri, j, 0], cand[ci, ri, j, 1:4] = h, pos
                valid[ci, ri, j] = True
    return cand, valid, np.arange(n_regions), truth, truth_idx


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def test_spots_to_hzxys_and_intensity_picks_match_jax():
    cand, valid, _, _, _ = _population(0)
    spots = np.random.default_rng(0).uniform(0, 50, (7, 5, 11)).astype(
        np.float32)
    _close(tpp.spots_to_hzxys(torch.from_numpy(spots)),
           jpp.spots_to_hzxys(jnp.asarray(spots)), rtol=1e-6)
    np.testing.assert_array_equal(
        tpp.pick_spots_by_intensities(*_t(cand, valid), **CPU).numpy(),
        np.asarray(jpp.pick_spots_by_intensities(*_j(cand, valid))))


@pytest.mark.parametrize("with_center", [False, True])
def test_chromosome_center_dists_match_jax(with_center):
    cand, valid, _, _, _ = _population(1, n_chr=1)
    cand[0, 3, 2] = 1.0                     # a finite invalid slot
    valid[0, 3, 2] = False
    ctr = np.asarray([5000.0, 6000.0, 5500.0], np.float32)
    args = [] if not with_center else [ctr]
    _close(tpp.chromosome_center_dists(*_t(cand[0], valid[0], *args)),
           jpp.chromosome_center_dists(*_j(cand[0], valid[0], *args)),
           rtol=1e-5)


@pytest.mark.parametrize("with_channels", [False, True])
def test_local_center_dists_match_jax(with_channels):
    """A batch of chromosomes, each row equal to JAX's call on its own
    trace; NaN where a window holds no finite pick."""
    cand, valid, ids, _, _ = _population(2, n_chr=3)
    picked = np.asarray(jpp.pick_spots_by_intensities(*_j(cand, valid)))
    chans = (ids % 2).astype(np.int32) if with_channels else None
    kw = dict(neighbor_len=3)
    extra_t = {} if chans is None else {"channels": torch.from_numpy(chans)}
    extra_j = {} if chans is None else {"channels": jnp.asarray(chans)}
    got = tpp.local_center_dists(*_t(cand, valid, ids, picked, ids), **kw,
                                 **extra_t)
    for k in range(3):
        want = jpp.local_center_dists(*_j(cand[k], valid[k], ids, picked[k],
                                          ids), **kw, **extra_j)
        _close(got[k], want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("channels,with_ref", [(False, False),
                                               (True, False), (False, True)])
def test_generate_reference_matches_jax(channels, with_ref):
    cand, valid, ids, truth, _ = _population(3)
    picked = np.asarray(jpp.pick_spots_by_intensities(*_j(cand, valid)))
    kw_t, kw_j = dict(neighbor_len=7, **CPU), dict(neighbor_len=7)
    if channels:
        chans = (ids % 2).astype(np.int32)
        kw_t.update(channels=torch.from_numpy(chans), n_channels=2)
        kw_j.update(channels=jnp.asarray(chans), n_channels=2)
    if with_ref:
        ref = truth.astype(np.float32)
        ref = np.concatenate([np.ones_like(ref[..., :1]), ref], -1)
        ctr = truth.mean(1).astype(np.float32)
        kw_t.update(ref_hzxys=torch.from_numpy(ref),
                    ref_centers=torch.from_numpy(ctr))
        kw_j.update(ref_hzxys=jnp.asarray(ref), ref_centers=jnp.asarray(ctr))
    got = tpp.generate_reference_from_population(*_t(picked, ids), **kw_t)
    want = jpp.generate_reference_from_population(*_j(picked, ids), **kw_j)
    for rows_t, cnt_t, rows_j, cnt_j in zip(got[::2], got[1::2], want[::2],
                                            want[1::2]):
        np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
        assert cnt_t.dtype == torch.int32
        for g in range(len(cnt_t)):
            n = int(cnt_t[g])
            _close(rows_t[g, :n], np.asarray(rows_j)[g, :n], **ROWS)
            assert torch.isinf(rows_t[g, n:]).all()


def test_cum_val_matches_jax():
    """Exact ranks with both boundary conventions, NaN and +-inf targets,
    ties, and an empty population."""
    rng = np.random.default_rng(4)
    ref = np.sort(rng.uniform(0, 100, 57)).astype(np.float32)
    row = np.concatenate([ref, np.full(7, np.inf, np.float32)])
    t = np.concatenate([rng.uniform(-5, 105, 30), [np.nan, np.inf, -np.inf,
                                                   ref[4], ref[-1]]])
    t = t.astype(np.float32)
    for cnt in (len(ref), 0):
        _close(tpp.cum_val(torch.from_numpy(row), torch.tensor(cnt),
                           torch.from_numpy(t)),
               jpp.cum_val(jnp.asarray(row), jnp.int32(cnt), jnp.asarray(t)),
               rtol=1e-6)


@pytest.mark.parametrize("split_int,split_dist,weights",
                         [(False, False, (1.0, 1.0)), (True, True, (1.0, 1.0)),
                          (True, False, (0.0, 2.0)), (False, False, (1.0, 0.0))])
def test_pick_spots_by_scores_matches_jax(split_int, split_dist, weights):
    cand, valid, ids, _, _ = _population(5, n_chr=4, n_regions=24)
    chans = (ids % 2).astype(np.int32)
    cand[:, chans == 1, :, 0] /= 8.0
    picked = np.asarray(jpp.pick_spots_by_intensities(*_j(cand, valid)))
    kw = dict(neighbor_len=5, n_channels=2, center_weight=weights[0],
              local_weight=weights[1], split_intensity_channels=split_int,
              split_distance_channels=split_dist)
    # each package scores against its own reference: a pick's distance is
    # then bit-equal to its entry in the reference (a tie both resolve)
    ref_j = jpp.generate_reference_from_population(
        *_j(picked, ids), neighbor_len=5, channels=jnp.asarray(chans),
        n_channels=2)
    ref_t = tpp.generate_reference_from_population(
        *_t(picked, ids), neighbor_len=5, channels=torch.from_numpy(chans),
        n_channels=2, **CPU)
    res_j = jpp.pick_spots_by_scores(*_j(cand, valid, ids, picked), ref_j,
                                     channels=jnp.asarray(chans), **kw)
    res_t = tpp.pick_spots_by_scores(*_t(cand, valid, ids, picked), ref_t,
                                     channels=torch.from_numpy(chans), **kw,
                                     **CPU)
    sc_j = np.asarray(res_j.all_scores)
    _close(res_t.all_scores, sc_j, **SCORES)
    srt = np.sort(sc_j, axis=-1)
    with np.errstate(invalid="ignore"):
        margin = srt[..., -1] - srt[..., -2]
    clear = valid.any(-1) & ((margin > 0.01) | np.isinf(margin))
    np.testing.assert_array_equal(res_t.sel_idx.numpy()[clear],
                                  np.asarray(res_j.sel_idx)[clear])
    _close(res_t.sel_scores, res_j.sel_scores, **SCORES)
    np.testing.assert_array_equal(np.isnan(res_t.sel_hzxys.numpy()),
                                  np.isnan(np.asarray(res_j.sel_hzxys)))


@pytest.mark.parametrize("seed,max_niter,with_init",
                         [(6, 10, False), (7, 2, False), (8, 10, True)])
def test_em_pick_spots_in_population_matches_jax(seed, max_niter,
                                                 with_init):
    cand, valid, ids, truth, truth_idx = _population(seed, n_chr=8,
                                                     n_regions=36)
    init = None
    if with_init:
        init = np.array(jpp.pick_spots_by_intensities(*_j(cand, valid)))
        init[:, ::5] = np.nan
    kw = dict(neighbor_len=5, max_niter=max_niter)
    res_j = jpp.em_pick_spots_in_population(
        *_j(cand, valid, ids), None if init is None else jnp.asarray(init),
        **kw)
    res_t = tpp.em_pick_spots_in_population(
        *_t(cand, valid, ids), None if init is None
        else torch.from_numpy(init), **kw, **CPU)
    np.testing.assert_array_equal(res_t.sel_idx.numpy(),
                                  np.asarray(res_j.sel_idx))
    np.testing.assert_array_equal(res_t.sel_hzxys.numpy(),
                                  np.asarray(res_j.sel_hzxys))
    _close(res_t.sel_scores, res_j.sel_scores, **SCORES)
    assert int(res_t.n_iters) == int(res_j.n_iters)
    assert res_t.n_iters.dtype == torch.int32
    _close(res_t.change_ratio, res_j.change_ratio, rtol=0, atol=0)
    has = truth_idx >= 0
    if max_niter == 10:
        assert (res_t.sel_idx.numpy()[has] == truth_idx[has]).mean() > 0.9


def test_evaluate_differences_and_screen_rna_match_jax():
    rng = np.random.default_rng(9)
    old = rng.uniform(0, 1000, (5, 12, 4)).astype(np.float32)
    new = old.copy()
    new[:, ::3, 1] += 5.0
    new[0, 1] = np.nan
    _close(tpp.evaluate_differences(*_t(old, new)),
           jpp.evaluate_differences(*_j(old, new)), rtol=1e-6)
    cand = rng.uniform(0, 2000, (10, 6, 4)).astype(np.float32)
    valid = rng.uniform(size=(10, 6)) > 0.2
    ref = rng.uniform(0, 2000, (8, 4)).astype(np.float32)
    ref[2] = np.nan
    to_ref = rng.integers(0, 8, 10)
    for keep in (False, True):
        np.testing.assert_array_equal(
            tpp.screen_rna_based_on_refs(*_t(cand, valid, to_ref, ref),
                                         dist_th=900.0,
                                         keep_no_ref=keep).numpy(),
            np.asarray(jpp.screen_rna_based_on_refs(
                *_j(cand, valid, to_ref, ref), dist_th=900.0,
                keep_no_ref=keep)))


def test_em_pick_spots_in_population_needs_a_card_without_device(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cand, valid, ids, _, _ = _population(10, n_chr=2, n_regions=6)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpp.em_pick_spots_in_population(*_t(cand, valid, ids))
