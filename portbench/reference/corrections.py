"""Corrections of the plain reference: a copy of imageanalysis3_tpu_torch/ops/corrections.py.

Frozen at the port's commit 5edc061; edit only to fix the reference.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .filters import (counting_median_layers_and_global, full_f32_matmul,
                      gaussian_highpass)


def deinterleave_stack(raw: torch.Tensor, rel_starts: Sequence[int],
                       n_colors: int, n_z: int) -> torch.Tensor:
    """De-interleave a raw frame window -> (C, Z, H, W): channel c's
    z-stack is ``raw[rel_starts[c] :: n_colors][:n_z]``."""
    return torch.stack([raw[s:s + (n_z - 1) * n_colors + 1:n_colors]
                        for s in rel_starts])


def remove_hot_pixels(im: torch.Tensor, hot_pix_th: float = 0.5,
                      hot_th: float = 4.0) -> torch.Tensor:
    """Replace camera hot pixels with their 4-neighbor mean.

    A pixel column (x, y) is hot when its intensity exceeds ``hot_th`` x
    (4-neighbor mean, wrapping like ``torch.roll``) in more than
    ``hot_pix_th`` of z-layers; hot columns away from the xy border are
    replaced by the 4-neighbor mean in every layer.
    """
    imf = im.to(torch.float32)
    neigh = (torch.roll(imf, 1, 1) + torch.roll(imf, -1, 1)
             + torch.roll(imf, 1, 2) + torch.roll(imf, -1, 2)) * 0.25
    hot_frac = (imf > hot_th * neigh).to(torch.float32).mean(dim=0)
    hot2d = hot_frac > hot_pix_th
    _, x, y = imf.shape
    hot2d[0, :] = False
    hot2d[x - 1, :] = False
    hot2d[:, 0] = False
    hot2d[:, y - 1] = False
    return torch.where(hot2d[None], neigh, imf)


def z_shift_correct(im: torch.Tensor,
                    median_subsample: int = 1) -> torch.Tensor:
    """out = im / median(im, axis=(x,y)) * median(im) (reference
    corrections.py:479-487); ``median_subsample`` as in
    filters.counting_median_layers_and_global (1 = exact)."""
    imf = im.to(torch.float32)
    layer_med, global_med = counting_median_layers_and_global(
        imf, subsample=median_subsample)
    return imf / layer_med[:, None, None] * global_med


def bleedthrough_unmix(ims: torch.Tensor,
                       profile: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_j ims[j] * profile[i, j] (per-pixel 2D maps).
    `ims`: (C, Z, X, Y); `profile`: (C, C, X, Y).  Full f32 whatever the
    caller's TF32 setting, as the reference runs it at HIGHEST."""
    with full_f32_matmul():
        return torch.einsum("ijxy,jzxy->izxy", profile.to(torch.float32),
                            ims.to(torch.float32))


def correct_channel_stack(
    ims: torch.Tensor,
    bleed_profile: Optional[torch.Tensor] = None,
    illumination_profile: Optional[torch.Tensor] = None,
    *,
    hot_pixel: bool = True,
    hot_pixel_th: float = 0.5,
    hot_pixel_ratio: float = 4.0,
    z_shift: bool = True,
    do_bleedthrough: bool = True,
    do_illumination: bool = True,
    do_highpass: bool = False,
    highpass_sigma: float = 3.0,
    highpass_truncate: float = 2.0,
    clip: bool = True,
    clip_min: float = 0.0,
    clip_max: float = 65535.0,
    median_subsample: int = 1,
    sequential_channels: bool = False,
) -> torch.Tensor:
    """One correction pass over a `(C, Z, X, Y)` multi-channel stack.

    Stage order matches the reference chain (io_tools/load.py:166-521):
    hot-pixel -> z-shift -> bleedthrough -> illumination -> high-pass.

    The per-channel stages always run one channel at a time.
    ``sequential_channels`` writes each corrected channel straight into one
    preallocated output, so only one channel's temporaries are live (at
    60x2048x2048 one f32 channel is 1 GB); otherwise the channels are
    stacked at the end.  The values are identical.  The post stages then
    finish each channel in place.  Bleedthrough, the only stage that mixes
    channels, needs all of them at once in both modes.
    """
    c = ims.shape[0]

    def _map(fn, n):
        if not sequential_channels:
            return torch.stack([fn(i) for i in range(n)])
        out = None
        for i in range(n):
            x = fn(i)
            if out is None:
                out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                                  device=x.device)
            out[i] = x
        return out

    def _pre(i):
        x = ims[i].to(torch.float32)
        if hot_pixel:
            x = remove_hot_pixels(x, hot_pix_th=hot_pixel_th,
                                  hot_th=hot_pixel_ratio)
        if z_shift:
            x = z_shift_correct(x, median_subsample=median_subsample)
        return x

    out = _map(_pre, c)
    if do_bleedthrough and bleed_profile is not None:
        out = bleedthrough_unmix(out, bleed_profile)
        if clip:
            out = out.clamp(clip_min, clip_max)

    post_illum = do_illumination and illumination_profile is not None
    if post_illum or do_highpass or clip:
        def _post(i):
            x = out[i]
            if post_illum:
                x = x / illumination_profile[i][None].to(torch.float32)
            if do_highpass:
                x = gaussian_highpass(x, highpass_sigma, highpass_truncate)
            if clip:
                x = x.clamp(clip_min, clip_max)
            return x

        # `out` is this function's own tensor: finish each channel in place
        for i in range(c):
            out[i] = _post(i)
    return out
