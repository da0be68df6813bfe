"""The benchmark's ``dna_merfish.fov`` cell on the CPU at a tiny size, through
``portbench.harness.bench.run_cell``: one field of view's rounds through
``FovPipeline.process_round`` (the kernels as their plain versions, which
the reference copies), then its decode, checked against the plain
reference.  The unbroken run is correct with every number 0; a fault
planted in the program after its set-up is not correct."""

import copy
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.harness.bench import run_cell  # noqa: E402
from portbench.harness.spec import load_spec  # noqa: E402

torch.set_num_threads(2)
CELL = "dna_merfish.fov"
SEED = 2 ** 31 + 91


def tiny_spec():
    """The cell cut to a CPU-sized field of view: 6 rounds of 16x128x128,
    2 chromosomes of 4 regions, 30 distractors a channel, 64 seeds."""
    s = load_spec(CELL)
    c = copy.deepcopy(s.config)
    c["shape"] = [16, 128, 128]
    c["rounds_per_fov"] = 6
    c["chromosomes"], c["loci_per_chromosome"] = 2, 4
    c["scene"].update(
        distractors=30, beads=40,
        layout=dict(c["scene"]["layout"], center_z=8.0, origin=32.0,
                    pitch=64.0, grid_cols=2, step=[1.0, 4.0, 4.0],
                    z_clip=[4.0, 12.0], xy_clip=[12.0, 116.0],
                    margin_z=3.0, margin_xy=8.0, drift_max=2.0))
    c["pipeline"]["seed"]["max_num_seeds"] = 64
    c["pipeline"]["drift"]["drift_size"] = 64
    s.config = c
    s.checks = dict(s.checks, check_rounds=4)
    return s


def moved_spots(drv):
    """Every valid spot of every round 0.05 px off in x."""
    orig = drv.pipe.process_round

    def fn(ims, ref):
        res = orig(ims, ref)
        spots = res.spots.clone()
        spots[..., 2] += 0.05
        return res._replace(spots=spots)
    drv.pipe.process_round = fn


def moved_spot(drv):
    """The first valid spot of every round's first channel 0.05 px off in
    x."""
    orig = drv.pipe.process_round

    def fn(ims, ref):
        res = orig(ims, ref)
        spots = res.spots.clone()
        k = int(torch.nonzero(res.valid[0]).flatten()[0])
        spots[0, k, 2] += 0.05
        return res._replace(spots=spots)
    drv.pipe.process_round = fn


def swapped_group(drv):
    """Two decoded groups of different regions exchange a member spot."""
    dec = drv.decoder
    orig = dec.decode

    def fn(spots, bits, **kw):
        out = orig(spots, bits, **kw)
        g = dec.spot_groups
        ok = torch.nonzero(g.ok).flatten().tolist()
        a = ok[0]
        b = next(k for k in ok if int(g.region[k]) != int(g.region[a]))
        idx = g.spot_idx.clone()
        idx[a, 0], idx[b, 0] = g.spot_idx[b, 0], g.spot_idx[a, 0]
        dec.spot_groups = g._replace(spot_idx=idx)
        return out
    dec.decode = fn


def _run(hook=None, trace=False):
    return run_cell(CELL, SEED, 0.0, trace, device="cpu", spec=tiny_spec(),
                    driver_hook=hook)


def test_unbroken_run_is_correct():
    drivers = []
    out = _run(drivers.append)
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"rounds_per_s", "round_p95_ms", "setup_s"}
    assert all(c["value"] == 0.0 for c in out["checks"].values()), \
        out["checks"]
    assert set(out["checks"]) == {
        "drift_gap_px", "moved_share", "spot_gap_px", "group_mismatch_share",
        "trace_gap_nm", "assigned_gap"}
    # the spot gap over every pair and the order-decided share are read
    assert out["_numbers"]["paired_gap_px"] == 0.0
    assert 0.0 <= out["_numbers"]["order_decided_share"] < 0.05
    # one unit is one field of view: its rounds, then its decode
    drv = drivers[0]
    assert out["attempted"] == 6 and len(drv.last_rounds) == 6
    assert drv.last_decoded is not None and len(drv.last_decoded.groups)


@pytest.mark.parametrize("fault, number", [
    (moved_spots, "moved_share"),
    (moved_spot, "spot_gap_px"),
    (swapped_group, "group_mismatch_share")])
def test_fault_is_not_correct(fault, number):
    out = _run(fault)
    assert out["correct"] is False
    c = out["checks"][number]
    assert not c["value"] <= c["limit"], out["checks"]


def _table(rows):
    """One channel's (1, N, 11) table and mask from (z, x, y) rows."""
    t = np.zeros((1, len(rows), 11))
    t[0, :, 0] = 1000.0
    t[0, :, 1:4] = rows
    return t, np.ones((1, len(rows)), bool)


@pytest.mark.parametrize("decided, gap", [
    ([False, False, False], 0.3),   # every pair held
    ([False, True, False], 0.001),  # the 0.3 px pair's spot is decided
    ([True, True, True], 0.0)])     # nothing held
def test_held_gap_skips_order_decided_spots(decided, gap):
    from portbench.harness.held_spots import held_gap

    ref, vr = _table([[5, 10, 10], [5, 40, 40], [5, 80, 80]])
    prog, vp = _table([[5, 10, 10.001], [5, 40, 40.3], [5, 80, 80]])
    h = held_gap(prog, vp, ref, vr, np.array([decided]))
    assert h["spot_gap_px"] == pytest.approx(gap, abs=1e-9)
    assert (h["decided"], h["n_ref"]) == (sum(decided), 3)


def test_pixel_order_changes_only_the_order_of_a_spots_pixels():
    from portbench.reference import gaussian_fit
    from portbench.reference.pixel_order import permutation, pixel_order

    im = torch.rand(12, 24, 24)
    seeds = torch.tensor([[6.0, 12.0, 12.0], [5.0, 8.0, 15.0]])
    plain = gaussian_fit.gather_ball_plain(im, seeds, 3)
    for way in ("reversed", "rotated"):
        perm = permutation(way, plain[0].shape[1], "cpu")
        assert sorted(perm.tolist()) == list(range(plain[0].shape[1]))
        with pixel_order(way):
            moved = gaussian_fit.gather_ball_plain(im, seeds, 3)
        for a, b in zip(moved, plain):
            assert torch.equal(a, b[:, perm])
    assert gaussian_fit.gather_ball_plain(im, seeds, 3)[0].equal(plain[0])


@pytest.mark.parametrize("steps, named", [(0, [2]), (1, [1, 2, 3]),
                                          (2, [0, 1, 2, 3])])
def test_order_decided_spots_name_their_neighbours(steps, named):
    """A chain of seeds 8 px apart (neighbours within 2r = 10 px) and one
    far away: the decided middle seed names its neighbours a step a
    Jacobi round."""
    from portbench.reference.gaussian_fit import neighbor_lists
    from portbench.reference.pixel_order import with_neighbours

    seeds = torch.tensor([[5.0, 10.0, y] for y in (10.0, 18.0, 26.0, 34.0)]
                         + [[5.0, 90.0, 90.0]])
    nidx, nmask = neighbor_lists(seeds, torch.ones(5, dtype=torch.bool),
                                 max_neighbors=12, radius=5)
    decided = torch.zeros(5, dtype=torch.bool)
    decided[2] = True
    out = with_neighbours(decided, nidx, nmask, steps)
    assert torch.nonzero(out).flatten().tolist() == named
