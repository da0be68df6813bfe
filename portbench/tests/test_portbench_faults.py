"""A run with the timed path broken underneath comes out not correct:
every fault the cells can have, planted in the program after its set-up,
through the rest of a run on the CPU at a tiny size (no look for a
card).  The unbroken run is correct, with every number 0: on the CPU the
program runs its kernels' plain versions, which the reference copies."""

import pytest
import torch

from portbench.harness.bench import run_cell

from conftest import tiny_spec

SEED = 2 ** 31 + 77


def _wrap(drv, fn):
    orig = drv.pipe.process_round
    drv.pipe.process_round = lambda ims, ref: fn(orig(ims, ref))


def stale(drv):
    """A round that returns the state of an earlier one unchanged."""
    first = []

    def fn(res):
        if not first:
            first.append(res)
        return first[0]
    _wrap(drv, fn)


def half_batch(drv):
    """Half of each channel's spots left out."""
    def fn(res):
        keep = torch.arange(res.valid.shape[1]) % 2 == 0
        return res._replace(valid=res.valid & keep.to(res.valid.device))
    _wrap(drv, fn)


def moved_spot(drv):
    """One answer altered where it is produced: a fitted spot 0.05 px off."""
    def fn(res):
        spots = res.spots.clone()
        k = int(torch.nonzero(res.valid[0])[0])
        spots[0, k, 2] += 0.05
        return res._replace(spots=spots)
    _wrap(drv, fn)


def moved_drift(drv):
    """One answer altered where it is produced: the drift 0.02 px off."""
    _wrap(drv, lambda res: res._replace(drift=res.drift + 0.02))


def _run(cell, hook):
    return run_cell(cell, SEED, 1.0, False, device="cpu",
                    spec=tiny_spec(cell, check_rounds=16), driver_hook=hook)


@pytest.mark.parametrize("cell", ["seq_tracing.rounds",
                                  "seq_tracing.raw_host"])
def test_unbroken_run_is_correct(cell):
    out = _run(cell, None)
    assert out["correct"] is True
    assert set(out["metrics"]) == {"rounds_per_s", "round_p95_ms", "setup_s"}
    assert all(c["value"] == 0.0 for c in out["checks"].values())


@pytest.mark.parametrize("cell, fault, number", [
    ("seq_tracing.rounds", stale, "drift_gap_px"),
    ("seq_tracing.rounds", half_batch, "moved_share"),
    ("seq_tracing.rounds", moved_spot, "spot_gap_px"),
    ("seq_tracing.rounds", moved_drift, "drift_gap_px"),
    ("seq_tracing.raw_host", half_batch, "moved_share"),
    ("seq_tracing.raw_host", moved_spot, "spot_gap_px"),
    ("seq_tracing.raw_host", stale, "drift_gap_px"),
    ("seq_tracing.raw_host", moved_drift, "drift_gap_px")])
def test_fault_is_not_correct(cell, fault, number):
    out = _run(cell, fault)
    assert out["correct"] is False
    c = out["checks"][number]
    assert not c["value"] <= c["limit"], out["checks"]
