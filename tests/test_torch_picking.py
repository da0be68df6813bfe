"""PyTorch port vs JAX package: the pickers (naive, DP, EM, EM for several
chromosomes with shared or exclusive spots), candidate merging and
chromosome assignment, candidate tables and the picked-spot screen, on
seeded planted cells (a polymer trace of 30 nm jitter among decoys spread
4000 nm around its centre, as tests/test_picking.py plants them).

Tolerances: picks (`sel_idx`, `sel_valid`), iteration counts and masks
equal on scenes with clear margins; scores and totals rtol 2e-4."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from imageanalysis3_tpu.decode import checking as jc
from imageanalysis3_tpu.decode import picking as jp
from imageanalysis3_tpu_torch.decode import checking as tc
from imageanalysis3_tpu_torch.decode import picking as tp

torch.set_num_threads(2)
PX = np.array([200.0, 108.0, 108.0])
CPU = {"device": "cpu"}


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _polymer_trace(n, rng, step_nm=300.0, start=(2000, 5000, 5000)):
    steps = rng.normal(0, step_nm / np.sqrt(3), size=(n, 3))
    return np.asarray(start) + np.cumsum(steps, axis=0)


def _cell(seed, n_regions=40, n_decoys=5, drop_frac=0.15):
    """(cand (R, M, 11), valid, ids, truth slot, kept regions); dropped
    regions have no valid candidate."""
    rng = np.random.default_rng(seed)
    zxys = _polymer_trace(n_regions, rng)
    m = n_decoys + 1
    cand = np.zeros((n_regions, m, 11), np.float32)
    valid = np.zeros((n_regions, m), bool)
    truth = np.zeros(n_regions, np.int64)
    kept = rng.uniform(size=n_regions) >= drop_frac
    center = zxys.mean(0)
    for i in np.flatnonzero(kept):
        truth[i] = rng.integers(0, m)
        for j in range(m):
            if j == truth[i]:
                pos, h = zxys[i] + rng.normal(0, 30.0, 3), \
                    rng.uniform(800, 1500)
            else:
                pos, h = center + rng.normal(0, 4000.0, 3), \
                    rng.uniform(800, 2500)
            cand[i, j, 0], cand[i, j, 1:4] = h, pos / PX
            valid[i, j] = True
    return cand, valid, np.arange(n_regions, dtype=np.int32), truth, kept


def _two_homologs(seed, n_regions=24, contested=None, gap=6000.0):
    """Two homolog traces' candidates in one table (slots 0 and 1); with
    `contested`, that region holds one bright candidate between them,
    slightly nearer homolog A (tests/test_picking.py's contest)."""
    rng = np.random.default_rng(seed)
    a = _polymer_trace(n_regions, rng, start=(2000, 3000, 3000))
    b = _polymer_trace(n_regions, rng, start=(2000, 3000 + gap, 3000 + gap))
    cand = np.zeros((n_regions, 3, 11), np.float32)
    valid = np.zeros((n_regions, 3), bool)
    for i in range(n_regions):
        for k, z in enumerate((a, b)):
            cand[i, k, 0] = rng.uniform(800, 1500)
            cand[i, k, 1:4] = (z[i] + rng.normal(0, 30, 3)) / PX
            valid[i, k] = True
    if contested is not None:
        cand[contested] = 0
        valid[contested] = False
        cand[contested, 2, 0] = 5000.0
        cand[contested, 2, 1:4] = (0.55 * a[contested]
                                   + 0.45 * b[contested]) / PX
        valid[contested, 2] = True
    centers = np.stack([a.mean(0), b.mean(0)]) / PX
    return (cand, valid, np.arange(n_regions, dtype=np.int32),
            centers.astype(np.float32))


def _same_result(t, j, rtol=2e-4):
    """EMPickResult fields: picks, masks and counts equal; trace equal
    where picked (NaN elsewhere); scores to `rtol`."""
    np.testing.assert_array_equal(t.sel_idx.numpy(), np.asarray(j.sel_idx))
    np.testing.assert_array_equal(t.sel_valid.numpy(),
                                  np.asarray(j.sel_valid))
    np.testing.assert_array_equal(t.trace.numpy(), np.asarray(j.trace))
    np.testing.assert_allclose(t.scores.numpy(), np.asarray(j.scores),
                               rtol=rtol, atol=1e-5)
    np.testing.assert_array_equal(t.n_iters.numpy(), np.asarray(j.n_iters))
    assert t.n_iters.dtype == torch.int32
    np.testing.assert_array_equal(t.change_ratio.numpy(),
                                  np.asarray(j.change_ratio))


@pytest.mark.parametrize("with_center", [False, True])
def test_naive_pick_spots_matches_jax(with_center):
    cand, valid, _, _, _ = _cell(0)
    center = (np.asarray([10.0, 46.0, 46.0], np.float32) if with_center
              else None)
    tr_j, has_j = jp.naive_pick_spots(
        *_j(cand, valid), None if center is None else jnp.asarray(center))
    tr_t, has_t = tp.naive_pick_spots(
        *_t(cand, valid), None if center is None else torch.from_numpy(center),
        **CPU)
    np.testing.assert_array_equal(has_t.numpy(), np.asarray(has_j))
    np.testing.assert_array_equal(tr_t.numpy(), np.asarray(tr_j))


@pytest.mark.parametrize("seed", [1, 2])
def test_dynamic_pick_spots_matches_jax(seed):
    """Equal chains and totals with an id gap and empty regions (leading,
    inner and trailing), and the port's batch of two score tables equal
    to two single calls."""
    rng = np.random.default_rng(seed)
    r, m = 16, 5
    cand = np.zeros((r, m, 11), np.float32)
    cand[..., 1:4] = rng.uniform(0, 60, size=(r, m, 3))
    valid = rng.uniform(size=(r, m)) > 0.3
    valid[[0, 7, 15]] = False
    scores = rng.normal(0, 2, size=(2, r, m)).astype(np.float32)
    ids = np.concatenate([np.arange(8), np.arange(10, 18)]).astype(np.int32)
    nb = np.asarray([500.0, 350.0], np.float32)
    got = tp.dynamic_pick_spots(*_t(cand, valid, scores, ids, nb))
    for k in range(2):
        sel_j, tot_j = jp.dynamic_pick_spots(
            *_j(cand, valid, scores[k], ids), jnp.float32(nb[k]))
        sel_t, tot_t = tp.dynamic_pick_spots(*_t(cand, valid, scores[k], ids),
                                             float(nb[k]))
        np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
        np.testing.assert_allclose(float(tot_t), float(tot_j), rtol=2e-4)
        np.testing.assert_array_equal(got[0][k].numpy(), sel_t.numpy())
        assert float(got[1][k]) == float(tot_t)


def test_take_trace_matches_jax():
    cand, valid, _, _, _ = _cell(3, n_regions=12)
    sel = np.random.default_rng(3).integers(0, cand.shape[1], 12)
    tr_j, ok_j = jp.take_trace(*_j(cand, valid, sel))
    tr_t, ok_t = tp.take_trace(*_t(cand, valid, sel))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(tr_t.numpy(), np.asarray(tr_j))


@pytest.mark.parametrize("seed,num_iters,with_center",
                         [(3, 10, False), (4, 10, True), (5, 1, False)])
def test_em_pick_spots_matches_jax(seed, num_iters, with_center):
    cand, valid, ids, truth, kept = _cell(seed)
    center = None
    if with_center:
        center = (np.nanmean(np.where(valid[..., None], cand[..., 1:4],
                                      np.nan), axis=(0, 1))
                  .astype(np.float32))
    res_j = jp.em_pick_spots(*_j(cand, valid, ids),
                             chrom_center=None if center is None
                             else jnp.asarray(center), num_iters=num_iters)
    res_t = tp.em_pick_spots(*_t(cand, valid, ids),
                             chrom_center=None if center is None
                             else torch.from_numpy(center),
                             num_iters=num_iters, **CPU)
    _same_result(res_t, res_j)
    assert res_t.n_unresolved is None
    if num_iters == 10:
        assert (res_t.sel_idx.numpy()[kept] == truth[kept]).mean() >= 0.9


@pytest.mark.parametrize("seed,num_iters", [(6, 10), (7, 2)])
def test_em_pick_spots_for_chromosomes_matches_jax(seed, num_iters):
    """Shared spots: each chromosome's EM equal to JAX's vmapped one, its
    own n_iters included; a third centre far from both homologs stops at
    another iteration than theirs on seed 6."""
    cand, valid, ids, centers = _two_homologs(seed)
    centers = np.vstack([centers, [[10.0, 200.0, 20.0]]]).astype(np.float32)
    res_j = jp.em_pick_spots_for_chromosomes(*_j(cand, valid, ids), centers,
                                             num_iters=num_iters)
    res_t = tp.em_pick_spots_for_chromosomes(*_t(cand, valid, ids, centers),
                                             num_iters=num_iters, **CPU)
    _same_result(res_t, res_j)
    sel = res_t.sel_idx.numpy()
    assert (sel[0] == 0).mean() >= 0.95 and (sel[1] == 1).mean() >= 0.95
    if num_iters == 10:
        assert len(set(res_t.n_iters.tolist())) > 1


@pytest.mark.parametrize("contested,rounds", [(12, 3), (12, 0), (None, 3)])
def test_em_pick_spots_exclusive_matches_jax(contested, rounds):
    cand, valid, ids, centers = _two_homologs(5, contested=contested)
    kw = dict(share_spots=False, n_resolve_rounds=rounds)
    res_j = jp.em_pick_spots_for_chromosomes(*_j(cand, valid, ids), centers,
                                             **kw)
    res_t = tp.em_pick_spots_for_chromosomes(*_t(cand, valid, ids, centers),
                                             **kw, **CPU)
    _same_result(res_t, res_j)
    np.testing.assert_array_equal(res_t.n_unresolved.numpy(),
                                  np.asarray(res_j.n_unresolved))
    assert res_t.n_unresolved.dtype == torch.int32
    sel, ok = res_t.sel_idx.numpy(), res_t.sel_valid.numpy()
    assert not (ok[0] & ok[1] & (sel[0] == sel[1])).any()
    if contested is not None:
        assert (res_t.n_unresolved.numpy().sum() == 0) == (rounds > 0)


def test_build_candidate_table_matches_jax():
    rng = np.random.default_rng(8)
    spots = {5: rng.uniform(1, 9, (3, 11)), 2: rng.uniform(1, 9, (7, 11)),
             9: np.zeros((0, 11)), 4: rng.uniform(1, 9, (1, 11))}
    spots[2][3, 2] = np.nan
    for cap in (None, 4):
        for a, b in zip(tp.build_candidate_table(spots, capacity=cap),
                        jp.build_candidate_table(spots, capacity=cap)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


@pytest.mark.parametrize("hard,dist_th,n_lists",
                         [(True, 0.1, 1), (False, 0.1, 3), (True, 0.05, 1)])
def test_merge_spot_lists_matches_jax(hard, dist_th, n_lists):
    """Concatenated lists with near-duplicates and chains of them, so the
    first-come walk's order decides what is kept."""
    rng = np.random.default_rng(9)
    base = rng.uniform(0, 20, (30, 3))
    spots = np.zeros((90, 11), np.float32)
    spots[:, 1:4] = np.concatenate([base, base + rng.normal(0, 0.03, base.shape),
                                    base + rng.normal(0, 0.06, base.shape)])
    spots[:, 0] = rng.uniform(0, 3, 90)
    valid = rng.uniform(size=90) > 0.1
    kw = dict(dist_th=dist_th, intensity_th=1.0,
              hard_intensity_th=hard, n_lists=n_lists)
    want = np.asarray(jp.merge_spot_lists(*_j(spots, valid), **kw))
    got = tp.merge_spot_lists(*_t(spots, valid), **kw, **CPU).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < valid.sum()


def test_assign_spots_to_chromosomes_matches_jax():
    rng = np.random.default_rng(10)
    spots = np.zeros((60, 11), np.float32)
    spots[:, 1:4] = rng.uniform(0, 100, (60, 3))
    valid = rng.uniform(size=60) > 0.2
    chrom = rng.uniform(0, 100, (4, 3)).astype(np.float32)
    want = np.asarray(jp.assign_spots_to_chromosomes(*_j(spots, valid,
                                                         chrom)))
    got = tp.assign_spots_to_chromosomes(*_t(spots, valid, chrom), **CPU)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("with_center,percentile", [(False, 1.0),
                                                    (True, 30.0)])
def test_check_picked_spots_matches_jax(with_center, percentile):
    """A picked trace with a few far-off picks and unpicked regions: the
    same keep mask, scores to rtol 2e-4."""
    cand, valid, ids, _, _ = _cell(11)
    res = jp.em_pick_spots(*_j(cand, valid, ids))
    trace, ok = np.array(res.trace), np.asarray(res.sel_valid)
    idx = np.flatnonzero(ok)[:3]
    trace[idx, 1:4] += np.asarray([40.0, 60.0, -60.0], np.float32)
    center = (np.nanmean(trace[:, 1:4], axis=0).astype(np.float32)
              if with_center else None)
    kw = dict(check_percentile=percentile, hard_dist_th=4000.0)
    keep_j, sc_j = jc.check_picked_spots(
        jnp.asarray(trace), jnp.asarray(ok),
        None if center is None else jnp.asarray(center), **kw)
    keep_t, sc_t = tc.check_picked_spots(
        *_t(trace, ok), None if center is None else torch.from_numpy(center),
        **kw, **CPU)
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), rtol=2e-4)
    assert not keep_t.numpy()[idx].all() and keep_t.numpy().sum() > 10


def test_filter_candidate_spots_matches_jax():
    rng = np.random.default_rng(12)
    spots = rng.uniform(0, 4, (50, 11))
    spots[:, 0] *= 500
    spots[:, 4] *= 60
    valid = rng.uniform(size=50) > 0.2
    np.testing.assert_array_equal(tc.filter_candidate_spots(spots, valid),
                                  jc.filter_candidate_spots(spots, valid))


@pytest.mark.parametrize("entry", ["em_pick_spots", "naive_pick_spots",
                                   "em_pick_spots_exclusive"])
def test_pickers_need_a_card_without_device(entry, monkeypatch):
    """The entry points run on the card by default: with no CUDA device
    and no `device`, they raise, CPU tensors or not."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cand, valid, ids, centers = _two_homologs(13)
    args = {"em_pick_spots": (cand, valid, ids),
            "naive_pick_spots": (cand, valid),
            "em_pick_spots_exclusive": (cand, valid, ids, centers)}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(tp, entry)(*_t(*args))
