"""PyTorch port vs JAX package: the MERFISH group QC functions (seeding
groups, unused spots, nearest-unused invalid pairs, random invalid pairs,
group reference metrics, pair metrics, tuple self-scores) and the
candidate preparation (per-channel normalization, chromatic recentering),
on seeded group tables of tight bright groups among free spots.

Tolerances: masks and pair indices equal; metrics and scores rtol 1e-4 /
atol 1e-4; the random invalid pairs equal under one seeded generator."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from imageanalysis3_tpu.decode import merfish as jm
from imageanalysis3_tpu_torch.decode import merfish as tm

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


def _groups(spot_idx, n_spots_total):
    """The same SpotGroups in both packages: (JAX's, the port's)."""
    spot_idx = np.asarray(spot_idx, np.int32)
    p = spot_idx.shape[0]
    ok = np.any(spot_idx >= 0, axis=1)
    usage = np.zeros(n_spots_total, np.int32)
    for s in spot_idx[spot_idx >= 0]:
        usage[s] += 1
    fields = dict(spot_idx=spot_idx,
                  region=np.where(ok, np.arange(p), -1).astype(np.int32),
                  n_spots=(spot_idx >= 0).sum(1).astype(np.int32), ok=ok,
                  spot_usage=usage)
    return (jm.SpotGroups(**{k: jnp.asarray(v) for k, v in fields.items()}),
            tm.SpotGroups(**{k: torch.from_numpy(v.astype(np.int64)
                                                 if k == "spot_idx" else v)
                             for k, v in fields.items()}))


def _scene(seed, n_groups=40, n_free=30):
    """Tight bright pairs and triples plus free spots: (spots (N, 11),
    positions (N, 3) nm, groups' spot rows)."""
    rng = np.random.default_rng(seed)
    rows, pos, ints = [], [], []
    for k in range(n_groups):
        size = 2 + k % 2
        base = rng.uniform(0, 5000, 3)
        rows.append(list(range(len(pos), len(pos) + size))
                    + [-1] * (3 - size))
        for _ in range(size):
            pos.append(base + rng.normal(0, 80, 3))
            ints.append(rng.uniform(800, 1500))
    for _ in range(n_free):
        pos.append(rng.uniform(0, 5000, 3))
        ints.append(rng.uniform(200, 900))
    spots = np.zeros((len(pos), 11), np.float32)
    spots[:, 0] = ints
    return spots, np.asarray(pos, np.float32), rows


@pytest.mark.parametrize("num_cand", [1, 2])
def test_seeding_groups_and_unused_spots_match_jax(num_cand):
    g_j, g_t = _groups([[0, 1, -1], [1, 2, 5], [3, 4, -1], [-1, -1, -1]], 8)
    valid = np.ones(8, bool)
    valid[7] = False
    np.testing.assert_array_equal(
        tm.find_seeding_groups(g_t, num_cand).numpy(),
        np.asarray(jm.find_seeding_groups(g_j, num_cand)))
    np.testing.assert_array_equal(
        tm.find_unused_spots(g_t, torch.from_numpy(valid)).numpy(),
        np.asarray(jm.find_unused_spots(g_j, jnp.asarray(valid))))


def test_collect_invalid_pairs_matches_jax():
    """Nearest unused neighbour of each unused spot, across the port's row
    blocks (N > 4096)."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, 2000, (4200, 3)).astype(np.float32)
    unused = rng.uniform(size=4200) < 0.05
    unused[4150] = True
    i_j, j_j, ok_j = jm.collect_invalid_pairs(jnp.asarray(pos),
                                              jnp.asarray(unused))
    i_t, j_t, ok_t = tm.collect_invalid_pairs(torch.from_numpy(pos),
                                              torch.from_numpy(unused))
    assert i_t.dtype == j_t.dtype == torch.int32
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(j_t.numpy()[unused],
                                  np.asarray(j_j)[unused])


@pytest.mark.parametrize("seed,total", [(1, 200), (2, 1000)])
def test_generate_random_invalid_pairs_equal_jax(seed, total):
    rng = np.random.default_rng(seed)
    n_bits = 8
    pair_region = -np.ones((n_bits, n_bits), np.int32)
    for a, b in ((0, 1), (2, 5), (3, 4)):
        pair_region[a, b] = pair_region[b, a] = a
    bit_index = rng.integers(0, n_bits, 600).astype(np.int32)
    valid = rng.uniform(size=600) > 0.1
    got = tm.generate_random_invalid_pairs(
        bit_index, valid, pair_region, total_num=total,
        rng=np.random.default_rng(seed + 10))
    want = jm.generate_random_invalid_pairs(
        bit_index, valid, pair_region, total_num=total,
        rng=np.random.default_rng(seed + 10))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert len(got[0]) > 0


def test_group_and_pair_metrics_match_jax():
    spots, pos, rows = _scene(3)
    rows[5] = [rows[5][0], -1, -1]                  # a single-spot group
    g_j, g_t = _groups(rows, len(spots))
    got = tm.group_reference_metrics(g_t, *map(torch.from_numpy,
                                               (spots, pos)))
    want = jm.group_reference_metrics(g_j, jnp.asarray(spots),
                                      jnp.asarray(pos))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    rng = np.random.default_rng(3)
    i = rng.integers(0, len(spots), 50).astype(np.int32)
    j = rng.integers(0, len(spots), 50).astype(np.int32)
    ok = i != j
    got = tm.pair_metrics(*map(torch.from_numpy, (spots, pos, i, j, ok)))
    want = jm.pair_metrics(*map(jnp.asarray, (spots, pos, i, j, ok)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("control", ["none", "random", "nearest_unused"])
def test_tuple_self_scores_match_jax(control):
    """Without a control, against random invalid pairs, and against
    collect_invalid_pairs' nearest-unused pairs (the QC chain end to
    end); NaN distances of single-spot groups stay masked."""
    spots, pos, rows = _scene(4)
    rows[2] = [rows[2][0], -1, -1]
    g_j, g_t = _groups(rows, len(spots))
    args_j, args_t = [], []
    if control == "random":
        rng = np.random.default_rng(4)
        i = rng.integers(0, len(spots), 100).astype(np.int32)
        j = rng.integers(0, len(spots), 100).astype(np.int32)
        args_j = list(map(jnp.asarray, (i, j, i != j)))
        args_t = list(map(torch.from_numpy, (i, j, i != j)))
    elif control == "nearest_unused":
        valid = np.ones(len(spots), bool)
        args_j = list(jm.collect_invalid_pairs(
            jnp.asarray(pos), jm.find_unused_spots(g_j, jnp.asarray(valid))))
        args_t = list(tm.collect_invalid_pairs(
            torch.from_numpy(pos),
            tm.find_unused_spots(g_t, torch.from_numpy(valid))))
    got = tm.tuple_self_scores(g_t, torch.from_numpy(spots),
                               torch.from_numpy(pos), *args_t)
    want = jm.tuple_self_scores(g_j, jnp.asarray(spots), jnp.asarray(pos),
                                *args_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.isneginf(got.numpy()[2])


@pytest.mark.parametrize("ref_channel", [0, 2])
def test_channel_normalization_and_recentering_match_jax(ref_channel):
    rng = np.random.default_rng(5)
    spots = rng.uniform(0, 100, (90, 11)).astype(np.float32)
    spots[:, 0] = rng.uniform(100, 3000, 90)
    ch = rng.integers(0, 3, 90).astype(np.int32)
    spots[ch == 1, 1:4] += np.asarray([0.5, -1.0, 2.0], np.float32)
    valid = rng.uniform(size=90) > 0.1
    args_t = list(map(torch.from_numpy, (spots, ch, valid)))
    args_j = list(map(jnp.asarray, (spots, ch, valid)))
    np.testing.assert_allclose(
        tm.normalize_intensities_by_channel(*args_t, 3).numpy(),
        np.asarray(jm.normalize_intensities_by_channel(*args_j, 3)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tm.adjust_spots_by_chromatic_center(*args_t, 3, ref_channel).numpy(),
        np.asarray(jm.adjust_spots_by_chromatic_center(*args_j, 3,
                                                       ref_channel)),
        rtol=1e-5, atol=1e-4)
