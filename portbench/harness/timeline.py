"""The end-to-end arithmetic: a rate over the whole window and the tail
of all rounds' latencies."""

from __future__ import annotations

import math
from typing import Sequence


def rate(n: int, t_start: float, t_end: float) -> float:
    """Units completed per second between the window's start and the end
    of its last whole unit."""
    return n / (t_end - t_start)


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value with at least q
    percent of the values at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]
