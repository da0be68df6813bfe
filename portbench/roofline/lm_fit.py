"""``csrc/lm_fit.cu``: one launch fits n spots of p ball pixels for a
fixed number of LM iterations.

The fit of a channel makes one round-0 launch over the seed capacity at
``lm_iters`` iterations, then Jacobi refit launches over the contested
prefix, max(128, N/4) rounded up to 128, at max(8, lm_iters // 3)
iterations (``iter_fit_seed_points``).  Bytes (chip_smoke.py's
``_lm_bound``): pixels, coordinates and mask read once, centres, box,
initial and final parameters and eps.  Operations a pixel and iteration:
240 for model, residual, 10 J^T rows, g and the 55 H sums, 31 for the
trial cost; 62 a pixel for the first cost and eps; 12 CG steps of ~260 a
spot and iteration."""

from __future__ import annotations

from ..harness.peaks import least_seconds
from ..reference.gather import ball_offsets


def least_of(n: int, p: int, iters: int, pk):
    nbytes = n * p * (4 + 12 + 1) + n * (12 + 4 + 40 + 44)
    ops = n * (p * (iters * 271 + 62) + iters * 12 * 260)
    return least_seconds(nbytes, ops, pk)


def shapes(config: dict):
    """((n, p, iters) of round 0, (n, p, iters) of a refit)."""
    n = config["pipeline"]["seed"]["max_num_seeds"]
    f = config["pipeline"]["fit"]
    p = len(ball_offsets(f["radius"]))
    cap = min(n, max(128, -(-n // 4 // 128) * 128))
    return (n, p, f["lm_iters"]), (cap, p, max(8, f["lm_iters"] // 3))


def least(config: dict, pk, fits: int, launches: int) -> float:
    """Least seconds of `launches` launches made by `fits` channel fits."""
    first, refit = shapes(config)
    return (fits * least_of(*first, pk)[0]
            + max(launches - fits, 0) * least_of(*refit, pk)[0])
