"""Synthetic FISH scenes with known truth, rendered on the tensor's device.

The counterpart of ``imageanalysis3_tpu/synthetic.py``'s benchmark half:
:func:`sample_spot_params` is a NumPy copy (same draws from the same
``numpy.random.Generator``), and :func:`render_spots` / :func:`noisy_uint16`
render the scene on the device from kilobytes of spot parameters.  The
noise comes from a seeded ``torch.Generator``, so its bits differ from the
JAX package's; tests that compare the two packages make their noise with
NumPy and hand it to both.
"""

from __future__ import annotations

from typing import Optional, Tuple

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
