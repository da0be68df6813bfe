"""PyTorch port vs JAX package: the fit's gathers on the CPU.

The port's ``gather_cubes`` and ``gather_ball`` run their plain versions on
CPU tensors; the JAX side is the Pallas kernel
``scripts/ab_gather2.py:gather_aligned`` in interpret mode (its aligned
windows need X >= 24 and Y >= 256) and the vmapped ``dynamic_slice`` it
replaces, and ``gaussian_fit.gather_blocks``.  A gather copies values, so
every comparison is exact.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageanalysis3_tpu.ops import gaussian_fit as jg
from imageanalysis3_tpu_torch.ops import gather_kernel as gk
from imageanalysis3_tpu_torch.ops import gaussian_fit as tg

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import ab_gather2  # noqa: E402

torch.set_num_threads(2)


def _stack(shape, seed):
    return np.random.default_rng(seed).uniform(
        0, 1000, shape).astype(np.float32)


@pytest.mark.parametrize("radius", [4, 5])
def test_plain_matches_pallas_gather_and_dynamic_slice(radius):
    shape = (12, 48, 512)
    im = _stack(shape, radius)
    sides = gk.cube_sides(shape, radius)
    rng = np.random.default_rng(10 + radius)
    origins = np.stack([rng.integers(0, s - d + 1, 32)
                        for s, d in zip(shape, sides)], 1).astype(np.int32)
    starts = ab_gather2.aligned_starts(jnp.asarray(origins), shape)
    pallas = np.asarray(ab_gather2.gather_aligned(
        jnp.asarray(im), starts, sides, block=16, interpret=True))
    sliced = np.asarray(jax.vmap(lambda o: jax.lax.dynamic_slice(
        jnp.asarray(im), o, sides))(jnp.asarray(origins)))
    got = gk.gather_cubes_plain(torch.from_numpy(im),
                                torch.from_numpy(origins), sides).numpy()
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, sliced)


def _seeds(shape, n, seed):
    """Fractional seeds over the stack and a margin beyond it (negative and
    past-the-end rows included), finite."""
    rng = np.random.default_rng(seed)
    lo = np.full(3, -3.0)
    hi = np.asarray(shape, np.float64) + 3.0
    return rng.uniform(lo, hi, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("shape,radius", [((12, 128, 128), 4),
                                          ((12, 128, 128), 5),
                                          ((6, 96, 96), 5)],
                         ids=["r4", "r5", "thin_r5"])
def test_gather_blocks_matches_jax_everywhere(shape, radius):
    """Pixels, coords and mask equal JAX's on every entry, the masked ones
    included (same clipped cube origins, same clipped in-cube offsets); the
    thin stack has sz = 6 < 2r."""
    im = _stack(shape, 3)
    seeds = _seeds(shape, 64, 4)
    pj, cj, mj = jg.gather_blocks(jnp.asarray(im), jnp.asarray(seeds), radius)
    pt, ct, mt = tg.gather_blocks(torch.from_numpy(im),
                                  torch.from_numpy(seeds), radius)
    assert not np.asarray(mj).all()           # out-of-bounds pixels occur
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


def test_out_of_range_origins_stay_in_bounds():
    """Any origin, however far outside, reads the cube at its clipped
    origin; non-finite and huge centres in gather_blocks read inside the
    stack and are masked out, and the finite rows still equal JAX's."""
    shape = (12, 48, 64)
    im = _stack(shape, 5)
    sides = gk.cube_sides(shape, 5)
    big = np.iinfo(np.int32)
    origins = np.array([[big.min, big.max, -5], [-1, 40, 60],
                        [100, -100, big.max], [3, 4, 5]], np.int32)
    got = gk.gather_cubes_plain(torch.from_numpy(im),
                                torch.from_numpy(origins), sides).numpy()
    for o, cube in zip(origins, got):
        c = [min(max(int(v), 0), s - d) for v, s, d in zip(o, shape, sides)]
        np.testing.assert_array_equal(
            cube, im[c[0]:c[0] + sides[0], c[1]:c[1] + sides[1],
                     c[2]:c[2] + sides[2]])

    seeds = _seeds(shape, 8, 6)
    bad = seeds.copy()
    bad[:4] = [[np.nan, 3.0, 3.0], [np.inf, -np.inf, 2.0],
               [1e10, -1e10, 5.0], [np.nan, np.nan, np.nan]]
    pt, _, mt = tg.gather_blocks(torch.from_numpy(im), torch.from_numpy(bad),
                                 5)
    assert torch.isfinite(pt).all()
    assert not mt[1:3].any()
    assert set(np.unique(pt[:4].numpy())) <= set(np.unique(im))
    pj, _, mj = jg.gather_blocks(jnp.asarray(im), jnp.asarray(seeds), 5)
    np.testing.assert_array_equal(pt[4:].numpy(), np.asarray(pj)[4:])
    np.testing.assert_array_equal(mt[4:].numpy(), np.asarray(mj)[4:])


def test_gather_cubes_dispatches_cpu_to_plain():
    im = torch.from_numpy(_stack((12, 32, 40), 7))
    origins = torch.tensor([[0, 1, 2], [5, 20, 30], [-4, 99, 7]],
                           dtype=torch.int32)
    sides = gk.cube_sides(im.shape, 5)
    gk.launches = 0
    got = gk.gather_cubes(im, origins, sides)
    assert gk.launches == 0
    torch.testing.assert_close(got, gk.gather_cubes_plain(im, origins, sides),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        gk.gather_cubes_cuda(im, origins, sides)
    with pytest.raises(ValueError, match="sides"):
        gk.gather_cubes(im, origins, (13, 10, 10))


# seeds the fit can be handed besides finite ones: NaN (-> 0), +-inf and
# values beyond the int32 range (saturated), the edges of that range, whose
# ball positions wrap in int32 as XLA's sums do
_EXTREME = np.array([[np.nan, 3.0, 3.0], [np.inf, -np.inf, 2.0],
                     [1e10, -1e10, 5.0], [np.nan, np.nan, np.nan],
                     [2147483520.0, -3.0, 5.0],
                     [-2147483520.0, 5.0, 2147483520.0]], np.float32)


@pytest.mark.parametrize("shape,radius", [((12, 128, 128), 4),
                                          ((12, 128, 128), 5),
                                          ((12, 128, 128), 6),
                                          ((6, 96, 96), 5)],
                         ids=["r4", "r5", "r6", "thin_r5"])
def test_ball_plain_matches_jax_gather_blocks(shape, radius):
    """The ball entry's plain version (XLA's int32 conversion, then
    cube-then-pack) equals JAX's gather_blocks on every entry, masked ones
    included, for finite seeds in and around the stack and for non-finite
    and huge ones; gather_blocks itself returns it."""
    im = _stack(shape, 8)
    seeds = np.concatenate([_seeds(shape, 48, 9), _EXTREME])
    pj, cj, mj = jg.gather_blocks(jnp.asarray(im), jnp.asarray(seeds), radius)
    np.testing.assert_array_equal(
        gk._to_int32(torch.from_numpy(seeds)).numpy(),
        np.asarray(jnp.asarray(seeds).astype(jnp.int32)))
    got = gk.gather_ball_plain(torch.from_numpy(im), torch.from_numpy(seeds),
                               radius)
    assert got[0].shape == (len(seeds), len(gk.ball_offsets(radius)))
    for g, want in zip(got, (pj, cj, mj)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    for g, b in zip(got, tg.gather_blocks(torch.from_numpy(im),
                                          torch.from_numpy(seeds), radius)):
        assert torch.equal(g, b)
    assert not np.asarray(mj)[-len(_EXTREME):].all()


def test_gather_ball_dispatches_cpu_to_plain():
    """A CPU tensor takes the plain version and launches nothing; the CUDA
    wrapper refuses CPU tensors, and a tensor on another device has neither
    kernel nor plain version."""
    im = torch.from_numpy(_stack((12, 32, 40), 7))
    base = torch.tensor([[0, 1, 2], [5, 20, 30], [-4, 99, 7]],
                        dtype=torch.int32)
    gk.launches = 0
    for seeds in (base, base.to(torch.float32) + 0.5):
        got = gk.gather_ball(im, seeds, 5)
        for g, want in zip(got, gk.gather_ball_plain(im, seeds, 5)):
            assert torch.equal(g, want)
        with pytest.raises(ValueError, match="CUDA"):
            gk.gather_ball_cuda(im, seeds, 5)
    assert gk.launches == 0
    with pytest.raises(ValueError, match="no kernel for device"):
        gk.gather_ball(im.to("meta"), base, 5)
