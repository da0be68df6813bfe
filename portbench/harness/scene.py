"""Scene generators of the benchmark: raw rounds with planted truth,
rendered on the device from the run's seed.

Frozen copies of the port's ``synthetic.py`` (``sample_spot_params``,
``render_spots``, ``noisy_uint16``, ``illumination_profile``,
``PLANTED_SHIFTS``, ``_poly_shift_np``) and of ``io.dax``'s frame
interleave, so that a change to the program cannot move the inputs.  Two
changes from the originals: the splat accumulates in float64 before the
blur (``index_add_`` on the card adds in no fixed order, and a float32
sum would make one seed's inputs differ from run to run), and every fixed
seed of the originals is drawn from the run's seed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..reference.filters import gaussian_filter
from ..reference.warp import monomial_exponents

#: planted order-2 chromatic shifts (px) per dimension (z, x, y), as
#: coefficients of the monomials of the coordinates centred on the stack
#: and divided by its half-extent (the port's synthetic.PLANTED_SHIFTS)
PLANTED_SHIFTS = {
    0: ((0.2, 0.1, 0.2, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.1),
        (0.5, 0.0, 0.9, -0.3, 0.0, 0.0, 0.0, 0.4, 0.2, -0.2),
        (-0.3, 0.0, 0.2, 0.9, 0.0, 0.0, 0.0, -0.2, 0.1, 0.4)),
    2: ((-0.1, -0.05, 0.1, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),
        (-0.4, 0.0, -0.5, 0.2, 0.0, 0.0, 0.0, -0.3, 0.0, 0.1),
        (0.3, 0.0, -0.2, -0.6, 0.0, 0.0, 0.0, 0.0, 0.1, -0.3)),
}


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one draw of the run, from the run's seed and tags."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *tags])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng_of(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *tags))


def _separated(cand: np.ndarray, accepted: list, sep: float, need: int,
               grid: dict) -> int:
    """Greedy pass over candidate centres in order: accept one when no
    accepted centre lies within `sep` (a hash grid of `sep`-sized cells
    stands in for the distance to every accepted centre).  Returns how
    many candidates were consumed when `need` were accepted, or all."""
    for k, c in enumerate(cand):
        if len(accepted) >= need:
            return k
        if sep > 0:
            key = tuple((c // sep).astype(np.int64))
            near = False
            for dz in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    for dy in (-1, 0, 1):
                        for j in grid.get((key[0] + dz, key[1] + dx,
                                           key[2] + dy), ()):
                            if np.linalg.norm(accepted[j] - c) < sep:
                                near = True
                                break
                        if near:
                            break
                    if near:
                        break
                if near:
                    break
            if near:
                continue
            grid.setdefault(key, []).append(len(accepted))
        accepted.append(c)
    return len(cand)


def sample_spot_params(shape, n_spots, rng, height_range=(300.0, 3000.0),
                       sigma_zxy=(1.35, 1.9, 1.9), sigma_jitter=0.15,
                       background=150.0, min_separation=0.0,
                       edge_margin=8.0) -> dict:
    """A random spot field's truth: centres rejection-sampled at
    `min_separation` (at most 200 trials a spot), heights and widths.
    The same draws, in the same order, as the port's one-trial-at-a-time
    loop: candidates are drawn in blocks and the generator is rewound to
    just after the last candidate the loop would have drawn."""
    shape = tuple(int(s) for s in shape)
    margin = np.minimum(np.full(3, float(edge_margin)), np.array(shape) / 3.0)
    lo, hi = margin, np.array(shape) - margin
    accepted, grid, trials = [], {}, 0
    max_trials = n_spots * 200
    while len(accepted) < n_spots and trials < max_trials:
        state = rng.bit_generator.state
        block = min(max(2 * (n_spots - len(accepted)), 64),
                    max_trials - trials)
        cand = rng.uniform(lo, hi, size=(block, 3))
        used = _separated(cand, accepted, float(min_separation), n_spots,
                          grid)
        if used < block:
            rng.bit_generator.state = state
            rng.uniform(lo, hi, size=(used, 3))
        trials += used
    centers = np.array(accepted) if accepted else np.zeros((0, 3))
    n = len(centers)
    heights = rng.uniform(*height_range, size=n)
    sigmas = np.array(sigma_zxy) * (1 + rng.uniform(-sigma_jitter,
                                                    sigma_jitter, size=(n, 3)))
    return {"centers": centers, "heights": heights, "sigmas": sigmas,
            "background": background}


def render_spots(shape, centers, heights, sigma_zxy=(1.35, 1.9, 1.9),
                 background=120.0, device="cuda") -> torch.Tensor:
    """Gaussian spots on `device`: each spot's mass splatted trilinearly
    onto its 8 corner voxels (in float64), then one separable Gaussian
    blur; widths come out as sqrt(sigma^2 + 1/6)."""
    shp = tuple(int(s) for s in shape)
    cen = torch.as_tensor(np.asarray(centers, np.float64), device=device)
    hts = torch.as_tensor(np.asarray(heights, np.float64), device=device)
    z0 = torch.floor(cen).to(torch.int64)
    frac = cen - z0.to(torch.float64)
    mass = hts * float(np.prod([np.sqrt(2 * np.pi) * s for s in sigma_zxy]))
    flat = torch.zeros(shp[0] * shp[1] * shp[2], dtype=torch.float64,
                       device=device)
    dims = torch.tensor(shp, device=device)
    for dz in (0, 1):
        for dx in (0, 1):
            for dy in (0, 1):
                corner = z0 + torch.tensor([dz, dx, dy], device=device)
                w = ((frac[:, 0] if dz else 1 - frac[:, 0])
                     * (frac[:, 1] if dx else 1 - frac[:, 1])
                     * (frac[:, 2] if dy else 1 - frac[:, 2]))
                inb = ((corner >= 0) & (corner < dims[None])).all(dim=-1)
                cp = torch.minimum(corner.clamp_min(0), dims[None] - 1)
                idx = (cp[:, 0] * shp[1] + cp[:, 1]) * shp[2] + cp[:, 2]
                flat.index_add_(0, idx, torch.where(inb, w * mass, 0.0))
    im = flat.to(torch.float32).reshape(shp)
    del flat
    im = gaussian_filter(im, tuple(float(s) for s in sigma_zxy))
    return im + float(background)


def noisy_uint16(im: torch.Tensor, seed: int, read_noise: float = 2.0,
                 illumination=None) -> torch.Tensor:
    """Shot + read noise (Gaussian approximation to Poisson) under an
    optional vignette, uint16-clipped, from a seeded torch.Generator on the
    image's device."""
    gen = torch.Generator(device=im.device)
    gen.manual_seed(int(seed))
    out = im if illumination is None else im * illumination[None]
    lam = out.clamp_min(0.0)
    shot = lam + lam.sqrt() * torch.randn(im.shape, generator=gen,
                                          device=im.device)
    shot = shot + read_noise * torch.randn(im.shape, generator=gen,
                                           device=im.device)
    return shot.clamp(0, 65535).to(torch.uint16)


def illumination_profile(shape_xy, falloff: float = 0.35) -> np.ndarray:
    """Smooth vignette in (0, 1], peak 1.0 at the centre."""
    x = np.linspace(-1, 1, shape_xy[0])[:, None]
    y = np.linspace(-1, 1, shape_xy[1])[None, :]
    return np.clip(1.0 - falloff * (x ** 2 + y ** 2) / 2.0, 0.2, 1.0)


def chromatic_constants(shape, which: int) -> np.ndarray:
    """PLANTED_SHIFTS[which] as (3, 10) constants over coordinates centred
    on the stack (px)."""
    half = np.asarray(shape, np.float64) / 2.0
    scale = np.array([1.0 / np.prod(half ** np.asarray(e))
                      for e in monomial_exponents(3, 2)])
    return (np.asarray(PLANTED_SHIFTS[which]) * scale[None]).astype(np.float32)


def poly_shift(coords: np.ndarray, constants: np.ndarray,
               ref_center: np.ndarray) -> np.ndarray:
    """Order-2 polynomial shift at (N, 3) coords, in the warp's monomial
    order."""
    d = coords - ref_center[None]
    cols = []
    for e in monomial_exponents(3, 2):
        c = np.ones(len(coords))
        for dim, p in enumerate(e):
            if p:
                c = c * d[:, dim] ** p
        cols.append(c)
    return np.stack(cols, axis=-1) @ np.asarray(constants, np.float64).T


def interleave_window(stacks: torch.Tensor, buffer_frames: int
                      ) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """A (C, Z, X, Y) round as the raw frame window a movie holds after
    `buffer_frames` warm-up frames (frame buffer + k carries channel
    (k + buffer) % C, as io.dax.interleave_channels writes it) ->
    ((Z * C, X, Y) frames, each channel's first frame in the window)."""
    c, z = stacks.shape[:2]
    rel = tuple((ch - buffer_frames) % c for ch in range(c))
    out = torch.empty((z * c,) + tuple(stacks.shape[2:]), dtype=stacks.dtype,
                      device=stacks.device)
    for ch in range(c):
        out[rel[ch]::c] = stacks[ch]
    return out, rel


# ---------------------------------------------------------------------------
# The planted-rounds scene (sequential tracing)
# ---------------------------------------------------------------------------


class PlantedScene:
    """Rounds of `channels` stacks: every data channel images its own fresh
    spot field each round, the bead channel the same bead field; a round's
    content moves by its sub-pixel drift; channels in `chromatic_channels`
    image a point p at p + shift(p) (PLANTED_SHIFTS), and the vignette
    dims the channels in `vignette_channels`.  Round -1 is the reference
    round (no drift).  `p` is the configuration's ``scene`` section."""

    def __init__(self, p: dict, shape, n_channels: int, drift_idx: int,
                 seed: int):
        self.p, self.shape, self.seed = p, tuple(shape), int(seed)
        self.n_channels, self.drift_idx = int(n_channels), int(drift_idx)
        self.data_idx = [c for c in range(n_channels) if c != drift_idx]
        self.beads = sample_spot_params(
            shape, p["beads"], rng_of(seed, 1), min_separation=p["bead_separation"],
            height_range=tuple(p["bead_heights"]), sigma_jitter=0.0,
            background=p["bead_background"])
        self.vignette = illumination_profile(shape[1:], p["vignette"])
        self.half = np.asarray(shape, np.float64) / 2.0
        self.chromatic = np.zeros((n_channels, 3, 10), np.float32)
        for k, ci in enumerate(p["chromatic_channels"]):
            self.chromatic[ci] = chromatic_constants(shape, k * 2)

    def illumination(self) -> np.ndarray:
        """(C, X, Y) profiles the pipeline divides by: the vignette on the
        vignetted channels, flat on the others."""
        out = np.ones((self.n_channels,) + self.shape[1:], np.float32)
        for ci in self.p["vignette_channels"]:
            out[ci] = self.vignette
        return out

    def drift(self, r: int) -> np.ndarray:
        if r < 0:
            return np.zeros(3)
        m = self.p["drift_max_px"]
        return rng_of(self.seed, 2, r).uniform(-m, m, 3)

    def truth(self, r: int, ci: int) -> dict:
        p = self.p
        return sample_spot_params(
            self.shape, p["spots_per_channel"], rng_of(self.seed, 3, r + 1, ci),
            min_separation=p["spot_separation"],
            height_range=tuple(p["spot_heights"]), sigma_jitter=0.0)

    def round_stack(self, r: int, device) -> torch.Tensor:
        """Round r's raw (C, Z, X, Y) uint16 stack on `device`."""
        p, d = self.p, self.drift(r)
        vig = torch.as_tensor(self.vignette.astype(np.float32), device=device)
        out = torch.empty((self.n_channels,) + self.shape, dtype=torch.uint16,
                          device=device)
        for ci in range(self.n_channels):
            if ci == self.drift_idx:
                t, bg = self.beads, p["bead_background"]
            else:
                t, bg = self.truth(r, ci), p["spot_background"]
            c = t["centers"]
            if ci in p["chromatic_channels"]:
                c = c + poly_shift(c, self.chromatic[ci], self.half)
            im = render_spots(self.shape, c + d, t["heights"], background=bg,
                              device=device)
            out[ci] = noisy_uint16(
                im, sub_seed(self.seed, 4, r + 1, ci), p["read_noise"],
                illumination=vig if ci in p["vignette_channels"] else None)
            del im
        return out
