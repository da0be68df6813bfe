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
NumPy and hand it to both.  The NumPy ground-truth factory
(:func:`render_gaussian_spots`, :func:`random_spot_field`,
:func:`make_synthetic_fov`) and the on-disk experiment writer
(:func:`write_synthetic_experiment`, on the port's ``io.dax``) are copies of
the JAX package's: one seed writes the same bytes in either package.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .io.dax import interleave_channels, write_dax
from .ops.filters import gaussian_filter


def render_gaussian_spots(shape: Tuple[int, int, int],
                          centers: np.ndarray,
                          heights: np.ndarray,
                          sigmas: np.ndarray,
                          background: float = 100.0,
                          truncate: float = 8.0) -> np.ndarray:
    """Render axis-aligned 3D Gaussian spots onto a constant background.

    centers: (N, 3) zxy float px; heights: (N,); sigmas: (N, 3) px.
    Equivalent ground-truth generator to the reference's ``add_source``
    (External/Fitting_v4.py:139-161), vectorized per spot window.
    """
    im = np.full(shape, float(background), dtype=np.float64)
    for c, h, s in zip(np.atleast_2d(centers), np.atleast_1d(heights),
                       np.atleast_2d(sigmas)):
        rad = np.maximum((truncate * s).astype(int), 2)
        lo = np.maximum(np.floor(c - rad).astype(int), 0)
        hi = np.minimum(np.ceil(c + rad).astype(int) + 1, shape)
        if np.any(lo >= hi):
            continue
        zz, xx, yy = np.meshgrid(*[np.arange(l, u) for l, u in zip(lo, hi)],
                                 indexing="ij")
        d2 = (((zz - c[0]) / s[0]) ** 2 + ((xx - c[1]) / s[1]) ** 2
              + ((yy - c[2]) / s[2]) ** 2)
        im[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] += h * np.exp(-0.5 * d2)
    return im


def poisson_camera_noise(im: np.ndarray, rng: np.random.Generator,
                         read_noise: float = 2.0) -> np.ndarray:
    """Shot + read noise, clipped to the uint16 range."""
    noisy = rng.poisson(np.maximum(im, 0)).astype(np.float64)
    noisy += rng.normal(0.0, read_noise, size=im.shape)
    return np.clip(noisy, 0, 65535)


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


#: the JAX package's names for the two renderers above
render_spots_device = render_spots
noisy_uint16_device = noisy_uint16


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


# ---------------------------------------------------------------------------
# Planted optics (NumPy copies of the JAX package's synthetic.py:105-172)
# and the bead-calibration scene
# ---------------------------------------------------------------------------


def random_spot_field(shape: Tuple[int, int, int],
                      n_spots: int,
                      rng: np.random.Generator,
                      **kwargs) -> Tuple[np.ndarray, dict]:
    """A stack with `n_spots` random Gaussians; returns (image, truth dict)."""
    truth = sample_spot_params(shape, n_spots, rng, **kwargs)
    im = render_gaussian_spots(tuple(int(s) for s in shape),
                               truth["centers"], truth["heights"],
                               truth["sigmas"], truth["background"])
    return im, truth


def illumination_profile(shape_xy: Tuple[int, int],
                         falloff: float = 0.35,
                         rng: Optional[np.random.Generator] = None
                         ) -> np.ndarray:
    """Smooth vignetting profile in (0, 1], peak 1.0 at center."""
    x = np.linspace(-1, 1, shape_xy[0])[:, None]
    y = np.linspace(-1, 1, shape_xy[1])[None, :]
    prof = 1.0 - falloff * (x ** 2 + y ** 2) / 2.0
    if rng is not None:
        prof = prof * (1 + 0.01 * np.cos(3 * np.pi * x) * np.sin(2 * np.pi * y))
    return np.clip(prof, 0.2, 1.0)


def bleed_matrix(channels: int = 3, leak: float = 0.08,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Row-stochastic-ish mixing matrix M: observed = M @ true."""
    m = np.eye(channels)
    for i in range(channels):
        for j in range(channels):
            if abs(i - j) == 1:
                m[i, j] = leak * (1 + (0.3 * rng.standard_normal() if rng else 0))
    return m


def chromatic_shift_field(shape: Tuple[int, int, int],
                          coeffs_zxy: Sequence[np.ndarray]) -> np.ndarray:
    """Order-2 polynomial shift field, (3, Z, X, Y).

    Matches the reference's chromatic profile construction
    (correction_tools/chromatic.py:415 generate_polynomial_data):
    shift_d(z,x,y) = sum over monomials {1,z,x,y,z^2,x^2,y^2,zx,zy,xy}.
    """
    z, x, y = [np.arange(s, dtype=np.float64) for s in shape]
    zz, xx, yy = np.meshgrid(z, x, y, indexing="ij")
    mono = np.stack([np.ones_like(zz), zz, xx, yy, zz * zz, xx * xx,
                     yy * yy, zz * xx, zz * yy, xx * yy])
    out = np.stack([np.tensordot(np.asarray(c), mono, axes=1)
                    for c in coeffs_zxy])
    return out


def _poly_shift_np(coords: np.ndarray, constants: np.ndarray,
                   ref_center: np.ndarray, max_order: int = 2) -> np.ndarray:
    """Order-`max_order` polynomial shift field at (N, 3) coords, using the
    same monomial basis/order as ops.warp (reference
    correction_tools/chromatic.py:415-438)."""
    from .ops.warp import monomial_exponents

    d = coords - ref_center[None]
    cols = []
    for e in monomial_exponents(3, max_order):
        c = np.ones(len(coords))
        for dim, p in enumerate(e):
            if p:
                c = c * d[:, dim] ** p
        cols.append(c)
    X = np.stack(cols, axis=-1)                       # (N, n_mono)
    return X @ np.asarray(constants, np.float64).T    # (N, 3)


@dataclass
class SyntheticFov:
    """A synthetic multi-round, multi-channel field of view with ground truth."""

    ims: np.ndarray                    # (rounds, channels, Z, X, Y) uint16-range f32
    truth: list = field(default_factory=list)   # per (round, channel) truth dicts
    drifts: np.ndarray = None          # (rounds, 3) true zxy drifts vs round 0
    illumination: np.ndarray = None    # (channels, X, Y)
    bleed: np.ndarray = None           # (C, C) mixing matrix applied


def write_synthetic_experiment(root: str,
                               shape=(12, 128, 128),
                               n_rounds: int = 3,
                               n_regions_per_round: int = 2,
                               n_spots: int = 12,
                               seed: int = 0,
                               drift_scale: float = 2.0,
                               buffer_frames: int = 4,
                               fov_names: Sequence[str] = ("Conv_zscan_00.dax",),
                               channels: Sequence[str] = ("750", "647", "488"),
                               illumination_falloff: float = 0.0,
                               bleed_leak: float = 0.0,
                               chromatic_constants: Optional[dict] = None,
                               corr_channels: Sequence[str] = ("750", "647"),
                               calibration_rounds: bool = False,
                               n_beads: Optional[int] = None,
                               ) -> dict:
    """Write a miniature on-disk experiment: H*-prefixed hyb folders of
    interleaved .dax movies + a Color_Usage.csv, mirroring the reference's
    folder layout (get_img_info.py:12-33, 96-167).  The last channel carries
    fiducial beads (shared across rounds, drifted); each earlier channel
    carries one 'u<N>' unique region per round.  Returns ground truth:
    {'drifts': (R,3), 'regions': {region_id: {'centers', 'channel'}},
     'channels': [...], 'folders': [...]}.

    Optics distortions (all optional, applied in physical order — chromatic
    spot displacement, per-channel vignetting, detection bleed mixing):
      * ``illumination_falloff``: per-channel vignetting profile strength;
      * ``bleed_leak``: off-diagonal mixing among ``corr_channels``;
      * ``chromatic_constants``: {channel: (3, n_mono)} polynomial shift
        fields (about the image center) displacing that channel's spots.
    With ``calibration_rounds``, extra non-data folders are written the way
    real experiments calibrate: one single-labeled round per corr channel
    (``truth['bleed_folders']``) and one multi-color bead round
    (``truth['chromatic_folder']``), both carrying the same distortions, so
    tests can regenerate the profiles from the experiment's own data
    (reference Generate_bleedthrough_correction /
    Generate_chromatic_abbrevation inputs).
    """
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    channels = list(channels)
    n_data_ch = len(channels) - 1
    corr_idx = [channels.index(c) for c in corr_channels if c in channels]
    ref_center = np.asarray(shape, np.float64) / 2.0
    chromatic_constants = chromatic_constants or {}
    drifts = np.vstack([np.zeros(3),
                        rng.uniform(-drift_scale, drift_scale,
                                    size=(n_rounds - 1, 3))])
    # a denser bead field than the data channels: registration accuracy
    # scales with bead count (real fiducial channels carry hundreds)
    if n_beads is None:
        n_beads = max(2 * n_spots, 16)
    _, bead_truth = random_spot_field(shape, n_beads, rng,
                                      min_separation=10.0,
                                      height_range=(2000.0, 6000.0))
    # per-channel vignetting (0 falloff => exactly flat)
    illum = {}
    for ci, ch in enumerate(channels):
        f = illumination_falloff * (1.0 + 0.15 * ci)
        illum[ch] = (illumination_profile(shape[1:], falloff=f)
                     if illumination_falloff else
                     np.ones(shape[1:], np.float64))
    # detection mixing among corr channels (observed = M @ true)
    m = np.eye(len(corr_idx))
    if bleed_leak:
        m = bleed_matrix(len(corr_idx), leak=bleed_leak, rng=rng)
    truth = {"drifts": drifts, "regions": {}, "channels": list(channels),
             "folders": [], "illumination": illum, "bleed_matrix": m,
             "chromatic": dict(chromatic_constants),
             "corr_channels": list(corr_channels)}

    def displaced(centers: np.ndarray, ch: str) -> np.ndarray:
        if ch in chromatic_constants:
            return centers + _poly_shift_np(
                centers, chromatic_constants[ch], ref_center)
        return centers

    def distort_and_write(folder: str, stacks, row_entries):
        """Apply vignetting + bleed mixing, interleave, write."""
        obs = [im * illum[ch][None] for im, ch in zip(stacks, channels)]
        if bleed_leak and len(corr_idx) > 1:
            mixed = [sum(m[a, b] * obs[corr_idx[b]]
                         for b in range(len(corr_idx)))
                     for a in range(len(corr_idx))]
            for a, ci in enumerate(corr_idx):
                obs[ci] = mixed[a]
        movie = interleave_channels(
            [np.clip(im, 0, 65535).astype(np.uint16) for im in obs],
            buffer_frames=buffer_frames)
        os.makedirs(folder, exist_ok=True)
        for fov in fov_names:
            write_dax(os.path.join(folder, fov), movie)
        usage_rows.append([os.path.basename(folder)] + row_entries)

    usage_rows = []
    rid = 0
    for r in range(n_rounds):
        folder = os.path.join(root, f"H{r}R{r}")
        truth["folders"].append(folder)
        row_entries = []
        stacks = []
        for c in range(n_data_ch):
            rid += 1
            _, t = random_spot_field(shape, n_spots, rng,
                                     min_separation=14.0,
                                     height_range=(1500.0, 5000.0))
            centers = displaced(t["centers"] + drifts[r], channels[c])
            im = render_gaussian_spots(shape, centers, t["heights"],
                                       t["sigmas"], background=120.0)
            stacks.append(im)
            truth["regions"][rid] = {"centers": t["centers"],
                                     "heights": t["heights"],
                                     "channel": channels[c], "round": r}
            row_entries.append(f"u{rid}")
        bead_im = render_gaussian_spots(
            shape, bead_truth["centers"] + drifts[r],
            bead_truth["heights"], bead_truth["sigmas"], background=120.0)
        stacks.append(bead_im)
        row_entries.append("beads")
        distort_and_write(folder, stacks, row_entries)

    if calibration_rounds:
        # one single-labeled round per corr channel (reference
        # bleedthrough calibration experiments)
        truth["bleed_folders"] = {}
        for ci in corr_idx:
            ch = channels[ci]
            folder = os.path.join(root, f"Hbleed_{ch}")
            _, t = random_spot_field(shape, max(n_spots, 12), rng,
                                     min_separation=14.0,
                                     height_range=(3000.0, 8000.0))
            stacks = [np.full(shape, 120.0) for _ in channels]
            stacks[ci] = render_gaussian_spots(
                shape, displaced(t["centers"], ch), t["heights"],
                t["sigmas"], background=120.0)
            rows = ["null"] * len(channels)
            rows[ci] = "bleedcal"
            distort_and_write(folder, stacks, rows)
            truth["bleed_folders"][ch] = folder
        # one multi-color bead round (reference chromatic calibration):
        # the same bead field in every corr channel, each displaced by
        # that channel's chromatic field
        folder = os.path.join(root, "Hchromcal")
        _, t = random_spot_field(shape, max(n_spots, 12), rng,
                                 min_separation=16.0,
                                 height_range=(3000.0, 8000.0))
        stacks = [np.full(shape, 120.0) for _ in channels]
        for ci in corr_idx:
            stacks[ci] = render_gaussian_spots(
                shape, displaced(t["centers"], channels[ci]),
                t["heights"], t["sigmas"], background=120.0)
        distort_and_write(folder, stacks,
                          ["chromcal" if i in corr_idx else "null"
                           for i in range(len(channels))])
        truth["chromatic_folder"] = folder
        truth["chromatic_bead_centers"] = t["centers"]

    with open(os.path.join(root, "Color_Usage.csv"), "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["Hyb"] + list(channels))
        w.writerows(usage_rows)
    return truth


def make_synthetic_fov(shape=(16, 256, 256), n_rounds=3, n_channels=2,
                       n_spots=20, seed=0, drift_scale=3.0,
                       apply_illumination=True, apply_bleed=False,
                       noise=True) -> SyntheticFov:
    """Build a small multi-round FOV: same spot field per channel, shifted
    per round by a random drift, with vignetting and optional noise."""
    rng = np.random.default_rng(seed)
    shape = tuple(shape)
    prof = np.stack([illumination_profile(shape[1:], rng=rng)
                     for _ in range(n_channels)])
    drifts = np.vstack([np.zeros(3),
                        rng.uniform(-drift_scale, drift_scale,
                                    size=(n_rounds - 1, 3))])
    ims = np.zeros((n_rounds, n_channels) + shape, dtype=np.float32)
    truth = []
    base_fields = []
    for c in range(n_channels):
        _, t = random_spot_field(shape, n_spots, rng, min_separation=12.0)
        base_fields.append(t)
    for r in range(n_rounds):
        for c in range(n_channels):
            t = base_fields[c]
            centers = t["centers"] + drifts[r]
            im = render_gaussian_spots(shape, centers, t["heights"],
                                       t["sigmas"], t["background"])
            if apply_illumination:
                im = im * prof[c][None]
            if noise:
                im = poisson_camera_noise(im, rng)
            ims[r, c] = im.astype(np.float32)
            truth.append({"round": r, "channel": c, "centers": centers,
                          "heights": t["heights"], "sigmas": t["sigmas"]})
    return SyntheticFov(ims=ims, truth=truth, drifts=drifts,
                        illumination=prof, bleed=None)


CALIBRATION_SHAPE = (60, 2048, 2048)

#: planted order-2 chromatic shifts (px) of the non-reference channels, per
#: dimension (z, x, y), as coefficients of the monomials [1, z, x, y, z^2,
#: zx, zy, x^2, xy, y^2] (ops.warp's order) of the coordinates centred on
#: the stack and divided by its half-extent: up to ~2 px at the FOV edge,
#: whatever the stack's size
PLANTED_SHIFTS = {
    0: ((0.2, 0.1, 0.2, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.1),
        (0.5, 0.0, 0.9, -0.3, 0.0, 0.0, 0.0, 0.4, 0.2, -0.2),
        (-0.3, 0.0, 0.2, 0.9, 0.0, 0.0, 0.0, -0.2, 0.1, 0.4)),
    2: ((-0.1, -0.05, 0.1, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),
        (-0.4, 0.0, -0.5, 0.2, 0.0, 0.0, 0.0, -0.3, 0.0, 0.1),
        (0.3, 0.0, -0.2, -0.6, 0.0, 0.0, 0.0, 0.0, 0.1, -0.3)),
}


class CalibrationScene(NamedTuple):
    """Planted optics of a bead-calibration run and how to render its
    stacks on a device.

    One vignette (`illumination`, (X, Y), peak 1) for every channel, one
    mixing matrix (`mixing`, (C, C): observed = M @ true), and per channel
    a chromatic shift (`chromatic`, (C, 3, 10) constants over coordinates
    centred on `ref_center`; zero for `ref_channel`): channel c images a
    point p at p + shift_c(p).  Bleedthrough mixes the channels' shifted
    images, so the unmixed image of channel c is its own shifted image.
    The truth dicts are :func:`sample_spot_params`'s."""

    shape: Tuple[int, int, int]
    illumination: np.ndarray
    mixing: np.ndarray
    chromatic: np.ndarray
    ref_center: np.ndarray
    ref_channel: int
    illum_spots: list           # per illumination stack
    bleed_spots: list           # per calibration round: its labelled channel
    beads: dict                 # the bead field, in the reference channel
    round_spots: list           # per channel of the corrected round
    background: float

    def shifted(self, ci: int, centers: np.ndarray) -> np.ndarray:
        """Where channel `ci` images the points `centers` (N, 3)."""
        return centers + _poly_shift_np(np.asarray(centers, np.float64),
                                        self.chromatic[ci], self.ref_center)

    def _vignette(self, device) -> torch.Tensor:
        return torch.as_tensor(self.illumination.astype(np.float32),
                               device=device)

    def _image(self, ci: int, truth: dict, device) -> torch.Tensor:
        """Channel ci's spot image of `truth` (no background)."""
        return render_spots(self.shape, self.shifted(ci, truth["centers"]),
                            truth["heights"], background=0.0, device=device)

    def illumination_stack(self, k: int, device="cuda") -> torch.Tensor:
        """Flat-field stack k: sparse spots on a bright background under
        the vignette, (Z, X, Y) uint16."""
        t = self.illum_spots[k]
        im = render_spots(self.shape, t["centers"], t["heights"],
                          background=t["background"], device=device)
        return noisy_uint16(im, seed=500 + k,
                            illumination=self._vignette(device))

    def bleed_round(self, i: int, device="cuda") -> torch.Tensor:
        """Calibration round i, where only channel i is labelled: every
        channel c records mixing[c, i] times channel i's image, under the
        vignette -> (C, Z, X, Y) uint16."""
        img = self._image(i, self.bleed_spots[i], device)
        vig = self._vignette(device)
        chans = [noisy_uint16(float(self.mixing[c, i]) * img + self.background,
                              seed=600 + 10 * i + c, illumination=vig)
                 for c in range(len(self.mixing))]
        return torch.stack(chans)

    def bead_pair(self, ci: int, device="cuda"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The bead field imaged in channel `ci` and in the reference
        channel -> (tar_im, ref_im), each (Z, X, Y) uint16."""
        t = self.beads
        ims = [noisy_uint16(render_spots(self.shape, self.shifted(c,
                                                                  t["centers"]),
                                         t["heights"],
                                         background=t["background"],
                                         device=device),
                            seed=700 + 10 * ci + k)
               for k, c in enumerate((ci, self.ref_channel))]
        return ims[0], ims[1]

    def round_stack(self, device="cuda") -> torch.Tensor:
        """One round with every channel labelled (round_spots[c] in channel
        c) under all three optics: chromatic shift, mixing, vignette ->
        (C, Z, X, Y) uint16."""
        c = len(self.mixing)
        imgs = [self._image(j, self.round_spots[j], device) for j in range(c)]
        vig = self._vignette(device)
        chans = []
        for ci in range(c):
            obs = sum(float(self.mixing[ci, j]) * imgs[j] for j in range(c))
            chans.append(noisy_uint16(obs + self.background, seed=800 + ci,
                                      illumination=vig))
            del obs
        return torch.stack(chans)


def make_calibration_scene(shape: Tuple[int, int, int] = CALIBRATION_SHAPE,
                           n_channels: int = 3, ref_channel: int = 1,
                           falloff: float = 0.35, leak: float = 0.08,
                           n_illum_stacks: int = 4, n_illum_spots: int = 300,
                           n_bleed_spots: int = 300, n_beads: int = 500,
                           bead_separation: float = 20.0,
                           n_round_spots: int = 500,
                           seed: int = 7) -> CalibrationScene:
    """A bead-calibration run with known optics, drawn from
    ``default_rng(seed)``: `n_illum_stacks` flat-field stacks (spots 500-1500
    on a 400 background), one single-label round per channel
    (`n_bleed_spots` spots of 4000-8000, 14 px apart), a bead field of
    `n_beads` beads (2000-5000, `bead_separation` apart) and one round of
    `n_round_spots` spots per channel (1000-3000, 10 px apart over all
    channels).  The planted optics are :func:`illumination_profile`
    (`falloff`), :func:`bleed_matrix` (`leak`) and :data:`PLANTED_SHIFTS`
    (the reference channel unshifted); nothing is rendered until a stack
    is asked for."""
    from .ops.warp import monomial_exponents

    rng = np.random.default_rng(seed)
    shape = tuple(int(s) for s in shape)
    half = np.asarray(shape, np.float64) / 2.0
    scale = np.array([1.0 / np.prod(half ** np.asarray(e))
                      for e in monomial_exponents(3, 2)])
    chromatic = np.zeros((n_channels, 3, len(scale)), np.float32)
    for ci, rows in PLANTED_SHIFTS.items():
        if ci < n_channels and ci != ref_channel:
            chromatic[ci] = np.asarray(rows) * scale[None]
    illum = [sample_spot_params(shape, n_illum_spots, rng,
                                height_range=(500.0, 1500.0),
                                background=400.0)
             for _ in range(n_illum_stacks)]
    bleed = [sample_spot_params(shape, n_bleed_spots, rng,
                                min_separation=14.0,
                                height_range=(4000.0, 8000.0))
             for _ in range(n_channels)]
    beads = sample_spot_params(shape, n_beads, rng,
                               min_separation=bead_separation,
                               height_range=(2000.0, 5000.0),
                               background=120.0)
    spots = sample_spot_params(shape, n_round_spots * n_channels, rng,
                               min_separation=10.0,
                               height_range=(1000.0, 3000.0))
    round_spots = [{k: (v[ci::n_channels] if isinstance(v, np.ndarray)
                        else v) for k, v in spots.items()}
                   for ci in range(n_channels)]
    return CalibrationScene(
        shape=shape, illumination=illumination_profile(shape[1:], falloff),
        mixing=bleed_matrix(n_channels, leak), chromatic=chromatic,
        ref_center=half, ref_channel=int(ref_channel), illum_spots=illum,
        bleed_spots=bleed, beads=beads, round_spots=round_spots,
        background=100.0)
