"""The benchmark's own tests.  Tests marked ``card`` need a CUDA card and
skip without one (decided in the fixture, never at import); the rest run
on the CPU at tiny sizes, the program's kernels as their plain versions.

    python -m pytest portbench/tests -q          # from the checkout's root
"""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control reads TF32, which only "
                    "the card computes")
    return torch.device("cuda")


def tiny_spec(cell: str, **checks):
    """The cell's spec cut to a CPU-sized scene: same code paths, smaller
    stacks, fewer spots, seeds and rounds."""
    from portbench.harness.spec import load_spec

    s = load_spec(cell)
    c = copy.deepcopy(s.config)
    c["shape"] = [16, 128, 128]
    c["scene"].update(spots_per_channel=40, beads=40)
    c["pipeline"]["seed"]["max_num_seeds"] = 64
    c["pipeline"]["drift"]["drift_size"] = 64
    s.config = c
    s.traffic = dict(s.traffic, warm_units=1,
                     pool_rounds=min(s.traffic.get("pool_rounds", 2), 2))
    s.checks = dict(s.checks, **checks)
    return s
