"""The end-to-end arithmetic on a synthetic timeline."""

import pytest

from portbench.harness import timeline


def _run(lats):
    """Back-to-back rounds of the given latencies from t = 0: (rate, p95)."""
    return (timeline.rate(len(lats), 0.0, sum(lats)),
            timeline.percentile([1e3 * v for v in lats], 95))


def test_a_stall_moves_the_rate_and_the_tail():
    steady = [0.12] * 200
    stalled = list(steady)
    for i in range(0, 200, 10):           # 20 rounds stall by 0.5 s
        stalled[i] += 0.5
    r0, p0 = _run(steady)
    r1, p1 = _run(stalled)
    assert r0 == pytest.approx(200 / 24.0)
    assert p0 == pytest.approx(120.0)
    assert r1 == pytest.approx(200 / 34.0)
    assert p1 == pytest.approx(620.0)


def test_percentile_is_nearest_rank():
    v = list(range(1, 101))
    assert timeline.percentile(v, 95) == 95
    assert timeline.percentile(v, 50) == 50
    assert timeline.percentile([7.0], 95) == 7.0
    assert timeline.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 100], 95) == 100
