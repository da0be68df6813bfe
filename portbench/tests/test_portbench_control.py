"""The control fails: the plain reference computed in TF32, the precision
below the configurations' float32 with TF32 off, put in the program's
place, reads beyond a limit, while the program itself stays within every
limit.  On the card at a reduced size (the full-size readings, on a dozen
seeds, come from calibrate.py)."""

import copy

import pytest

from portbench.harness.bench import run_cell
from portbench.harness.spec import load_spec


def _reduced(cell):
    s = load_spec(cell)
    c = copy.deepcopy(s.config)
    # a sixteenth of the plane, with the spots, beads and seed cap cut alike
    c["shape"] = [c["shape"][0], 512, 512]
    c["scene"].update(spots_per_channel=c["scene"]["spots_per_channel"] // 16,
                      beads=c["scene"]["beads"] // 16)
    c["pipeline"]["seed"]["max_num_seeds"] //= 16
    c["pipeline"]["drift"]["drift_size"] = 128
    s.config = c
    return s


@pytest.mark.card
@pytest.mark.parametrize("cell", ["seq_tracing.rounds",
                                  "seq_tracing.raw_host"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_a_limit(card, cell, seed):
    out = run_cell(cell, seed, 1.0, False, spec=_reduced(cell), control=True)
    assert out["correct"] is True, out["checks"]
    limits = {k: c["limit"] for k, c in out["checks"].items()}
    ctrl = out["_control"]
    assert any(not ctrl[k] <= limits[k] for k in limits), (ctrl, limits)
