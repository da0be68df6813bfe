"""Synthetic FISH scenes with known truth, rendered on the tensor's device.

The counterpart of ``imageanalysis3_tpu/synthetic.py``'s benchmark half:
:func:`sample_spot_params` is a NumPy copy (same draws from the same
``numpy.random.Generator``), and :func:`render_spots` / :func:`noisy_uint16`
render the scene on the device from kilobytes of spot parameters.
:func:`make_e2e_scene` is bench_e2e.py's end-to-end scene (a pair-unique
codebook, homolog walks, distractors, beads and drifts) with the same
draws.  The
noise comes from a seeded ``torch.Generator``, so its bits differ from the
JAX package's; tests that compare the two packages make their noise with
NumPy and hand it to both.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .ops.filters import gaussian_filter


def sample_spot_params(shape: Tuple[int, int, int],
                       n_spots: int,
                       rng: np.random.Generator,
                       height_range: Tuple[float, float] = (300.0, 3000.0),
                       sigma_zxy: Tuple[float, float, float] = (1.35, 1.9,
                                                               1.9),
                       sigma_jitter: float = 0.15,
                       background: float = 150.0,
                       min_separation: float = 0.0,
                       edge_margin: float = 8.0) -> dict:
    """Sample a random spot field's ground-truth parameters (no render)."""
    shape = tuple(int(s) for s in shape)
    margin = np.minimum(np.full(3, float(edge_margin)),
                        np.array(shape) / 3.0)
    lo = margin
    hi = np.array(shape) - margin
    centers = []
    trials = 0
    while len(centers) < n_spots and trials < n_spots * 200:
        trials += 1
        c = rng.uniform(lo, hi)
        if min_separation > 0 and centers:
            d = np.linalg.norm(np.array(centers) - c, axis=1)
            if d.min() < min_separation:
                continue
        centers.append(c)
    centers = np.array(centers) if centers else np.zeros((0, 3))
    n = len(centers)
    heights = rng.uniform(*height_range, size=n)
    sigmas = np.array(sigma_zxy) * (1 + rng.uniform(-sigma_jitter,
                                                    sigma_jitter,
                                                    size=(n, 3)))
    return {"centers": centers, "heights": heights, "sigmas": sigmas,
            "background": background}


def render_spots(shape: Tuple[int, int, int], centers, heights,
                 sigma_zxy: Tuple[float, float, float] = (1.35, 1.9, 1.9),
                 background: float = 120.0,
                 device: "torch.device | str" = "cuda") -> torch.Tensor:
    """Render Gaussian spots on `device` by trilinear splat + blur.

    Each spot splats its mass onto its 8 corner voxels (``index_add_``),
    then one separable Gaussian blur shapes every spot at once.  The
    trilinear kernel is symmetric about the subpixel center, so spot
    centroids are exact; widths come out as sqrt(sigma^2 + 1/6).
    """
    shp = tuple(int(s) for s in shape)
    cen = torch.as_tensor(np.asarray(centers, np.float32), device=device)
    hts = torch.as_tensor(np.asarray(heights, np.float32), device=device)
    z0 = torch.floor(cen).to(torch.int64)                  # (N, 3)
    frac = cen - z0.to(torch.float32)
    # spot mass so the blurred peak equals `height`
    mass = hts * float(np.prod([np.sqrt(2 * np.pi) * s for s in sigma_zxy]))
    flat = torch.zeros(shp[0] * shp[1] * shp[2], dtype=torch.float32,
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
    im = gaussian_filter(flat.reshape(shp), tuple(float(s)
                                                   for s in sigma_zxy))
    return im + float(background)


def noisy_uint16(im: torch.Tensor, seed: int, read_noise: float = 2.0,
                 illumination: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Shot + read noise + optional vignetting, uint16-clipped, on the
    image's device (Gaussian approximation to Poisson at camera
    intensities).  `seed` seeds a ``torch.Generator`` on that device."""
    gen = torch.Generator(device=im.device)
    gen.manual_seed(int(seed))
    out = im if illumination is None else im * illumination[None]
    lam = out.clamp_min(0.0)
    shot = lam + lam.sqrt() * torch.randn(im.shape, generator=gen,
                                          device=im.device)
    shot = shot + read_noise * torch.randn(im.shape, generator=gen,
                                           device=im.device)
    return shot.clamp(0, 65535).to(torch.uint16)


# ---------------------------------------------------------------------------
# The end-to-end scene of bench_e2e.py: rounds of 3-channel stacks whose
# data channels carry the bits of a pair-unique codebook
# ---------------------------------------------------------------------------

E2E_SHAPE = (60, 2048, 2048)
E2E_PIXEL_SIZE_NM = (200.0, 108.0, 108.0)


class E2ELayout(NamedTuple):
    """Where the scene plants its chromosomes (px); the defaults are
    bench_e2e.py's for a 60x2048x2048 stack."""

    center_z: float = 30.0          # territory centre plane
    origin: float = 330.0           # first territory's x and y
    pitch: float = 480.0            # territory grid spacing
    grid_cols: int = 4
    step: Tuple[float, float, float] = (2.0, 22.0, 22.0)  # walk step sd
    z_clip: Tuple[float, float] = (10.0, 50.0)
    xy_clip: Tuple[float, float] = (60.0, 1988.0)
    jitter: float = 0.4             # per-bit spot jitter sd
    margin_z: float = 6.0           # distractor margins
    margin_xy: float = 20.0
    drift_max: float = 4.0          # integer drifts in [-max, max]
    n_beads: int = 120


def make_e2e_codebook(rng: np.random.Generator, n_chr: int, n_per_chr: int,
                      n_bits: int, n_on: int = 3):
    """Pair-unique n_on-bit codebook (every bit pair maps to at most one
    region: the reference's valid-pair invariant, classes/decode.py:
    177-205) as a column mapping: ``id``, ``name``, ``chr`` and one column
    per bit, "1".."n_bits".  Returns (columns, on-bit tuples)."""
    rows, used = [], set()
    tries = 0
    while len(rows) < n_chr * n_per_chr and tries < 200_000:
        tries += 1
        on = tuple(sorted(rng.choice(n_bits, n_on, replace=False)))
        pairs = {(a, b) for i, a in enumerate(on) for b in on[i + 1:]}
        if pairs & used:
            continue
        used |= pairs
        rows.append(on)
    if len(rows) < n_chr * n_per_chr:
        raise RuntimeError("codebook packing failed")
    columns = {"id": np.arange(len(rows)) + 100,
               "name": np.array([f"reg{i}" for i in range(len(rows))]),
               "chr": np.array([f"chr{c + 1}" for c in range(n_chr)
                                for _ in range(n_per_chr)])}
    for b in range(n_bits):
        columns[str(b + 1)] = np.array([int(b in on) for on in rows])
    return columns, rows


class E2EScene(NamedTuple):
    """Planted truth of an end-to-end scene and how to render its rounds.

    truth[(chr, homolog)]: (R, 3) px region positions; region_spots[(chr,
    homolog)]: (R, n_on, 3) the jittered spot positions planted for each
    region; bit_spots[bit]: (M, 3) px spot centres of that bit;
    distractors[(round, channel)]: (D, 3); drifts: (rounds, 3) integer px
    shifts applied to every channel of a round.
    """

    shape: Tuple[int, int, int]
    n_rounds: int
    n_data_ch: int
    codebook: dict
    rows: list
    truth: dict
    region_spots: dict
    bit_spots: dict
    bead_truth: dict
    drifts: np.ndarray
    distractors: dict

    def round_stack(self, r: int, device="cuda") -> torch.Tensor:
        """Round r's raw (n_data_ch + 1, Z, X, Y) uint16 stack, rendered on
        `device` (bench_e2e.py:167-186): data channels carry their bit's
        spots and the distractors, the last channel the bead field."""
        d = self.drifts[r]
        chans = []
        for ci in range(self.n_data_ch):
            b = r * self.n_data_ch + ci
            spots = self.bit_spots[b]
            n_d = len(self.distractors[(r, ci)])
            centers = np.vstack([spots, self.distractors[(r, ci)]])
            heights = np.concatenate([
                1800.0 + 600.0 * np.sin(np.arange(len(spots))),
                np.random.default_rng(7000 + b).uniform(500, 2500, n_d)])
            im = render_spots(self.shape, centers + d, heights,
                              background=150.0, device=device)
            chans.append(noisy_uint16(im, seed=3000 + b, read_noise=12.0))
            del im
        bead = render_spots(self.shape, self.bead_truth["centers"] + d,
                            self.bead_truth["heights"], background=120.0,
                            device=device)
        chans.append(noisy_uint16(bead, seed=1000 + r))
        return torch.stack(chans)


def make_e2e_scene(shape: Tuple[int, int, int] = E2E_SHAPE,
                   n_rounds: int = 20, n_data_ch: int = 2, n_chr: int = 6,
                   n_per_chr: int = 25, n_homologs: int = 2, n_on: int = 3,
                   n_distractors: int = 1500, seed: int = 42,
                   layout: E2ELayout = E2ELayout()) -> E2EScene:
    """bench_e2e.py's scene (its draws, in its order, from
    ``default_rng(seed)``): the codebook over n_rounds * n_data_ch bits,
    homolog territories on a grid with a polymer walk of region positions,
    one jittered spot per (region, homolog, on-bit), the bead field, the
    rounds' integer drifts and the per-channel distractors."""
    rng = np.random.default_rng(seed)
    n_bits = n_rounds * n_data_ch
    codebook, rows = make_e2e_codebook(rng, n_chr, n_per_chr, n_bits, n_on)
    lo = layout
    territories = {}
    for k, (c, h) in enumerate((c, h) for c in range(n_chr)
                               for h in range(n_homologs)):
        gx, gy = divmod(k, lo.grid_cols)
        territories[(c, h)] = np.array([lo.center_z,
                                        lo.origin + gx * lo.pitch,
                                        lo.origin + gy * lo.pitch])
    truth = {}
    for c in range(n_chr):
        for h in range(n_homologs):
            steps = rng.normal(0, 1, (n_per_chr, 3)) * list(lo.step)
            walk = territories[(c, h)] + np.cumsum(steps, axis=0)
            walk[:, 0] = np.clip(walk[:, 0], *lo.z_clip)
            walk[:, 1:] = np.clip(walk[:, 1:], *lo.xy_clip)
            truth[(c, h)] = walk
    bit_spots = {b: [] for b in range(n_bits)}
    region_spots = {key: np.zeros((n_per_chr, n_on, 3)) for key in truth}
    for gi, on in enumerate(rows):
        c, r = divmod(gi, n_per_chr)
        for h in range(n_homologs):
            pos = truth[(c, h)][r]
            for t, b in enumerate(on):
                spot = pos + rng.normal(0, lo.jitter, 3)
                bit_spots[b].append(spot)
                region_spots[(c, h)][r, t] = spot
    bit_spots = {b: np.asarray(v, np.float64).reshape(-1, 3)
                 for b, v in bit_spots.items()}
    bead_truth = sample_spot_params(shape, lo.n_beads, rng,
                                    min_separation=14.0,
                                    height_range=(2000.0, 5000.0),
                                    sigma_jitter=0.0)
    drifts = np.vstack([np.zeros(3), rng.uniform(
        -lo.drift_max, lo.drift_max, (n_rounds - 1, 3))]).round()
    mz, mxy = lo.margin_z, lo.margin_xy
    distractors = {
        (r, ci): np.column_stack([
            rng.uniform(mz, shape[0] - mz, n_distractors),
            rng.uniform(mxy, shape[1] - mxy, n_distractors),
            rng.uniform(mxy, shape[2] - mxy, n_distractors)])
        for r in range(n_rounds) for ci in range(n_data_ch)}
    return E2EScene(shape=tuple(shape), n_rounds=n_rounds,
                    n_data_ch=n_data_ch, codebook=codebook, rows=rows,
                    truth=truth, region_spots=region_spots,
                    bit_spots=bit_spots, bead_truth=bead_truth,
                    drifts=drifts, distractors=distractors)
