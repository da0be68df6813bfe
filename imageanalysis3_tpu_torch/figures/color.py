"""Colormap helpers for overlay rendering.

The counterpart of ``imageanalysis3_tpu/figures/color.py``: the same RGBA
tables.  Behavior targets (reference figure_tools/color.py):
  * white->primary ramps myReds/myBlues/myGreens (+_r)      :7-28
  * ``transparent_cmap``  alpha ramp over an existing map    :30-38
  * ``black_gradient``    black->color ramp                  :40-51
  * ``transparent_gradient`` constant color, alpha ramp      :53-62
  * ``normalize_color``   clip + rescale to [0, 1]           :64-77

Clean-room API note: the reference's transparent_cmap mutates the passed
colormap's private ``_lut``; here a NEW ListedColormap is built by
sampling, so library colormaps are never modified in place.

matplotlib is imported inside the functions; the six module-level ramps
are built on first access (a module ``__getattr__``), so importing this
module needs no matplotlib.
"""

from __future__ import annotations

import numpy as np

from ..device import host_array
from ._mpl import pyplot

_RAMPS = {"myReds": (1, 2), "myBlues": (0, 1), "myGreens": (0, 2)}


def _listed(colors):
    from matplotlib.colors import ListedColormap
    return ListedColormap(colors)


def _white_ramp(channel_offs):
    colors = np.ones((256, 4))
    for c in channel_offs:
        colors[:, c] = np.linspace(1, 0, 256)
    return _listed(colors)


def __getattr__(name):
    """white -> pure-primary ramps (reference myReds/myBlues/myGreens) and
    their reverses, built once on first access."""
    base = name[:-2] if name.endswith("_r") else name
    if base not in _RAMPS:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    cmap = _white_ramp(_RAMPS[base])
    if name != base:
        cmap = _listed(np.flipud(cmap.colors))
    globals()[name] = cmap
    return cmap


def transparent_cmap(cmap, increasing_alpha: bool = True, N: int = 256,
                     max_alpha: float = 1.0):
    """A copy of ``cmap`` whose alpha ramps linearly 0 -> max_alpha
    (or reversed), so low values vanish in overlays."""
    from matplotlib.colors import Colormap
    if isinstance(cmap, str):
        cmap = pyplot().get_cmap(cmap)
    assert isinstance(cmap, Colormap)
    colors = np.asarray(cmap(np.linspace(0.0, 1.0, N)))
    alpha = np.linspace(0.0, max_alpha, N)
    colors[:, 3] = alpha if increasing_alpha else alpha[::-1]
    return _listed(colors)


def black_gradient(color, num_colors: int = 256, max_alpha: float = 1.0,
                   transparent: bool = False):
    """Black -> ``color`` linear ramp; with ``transparent`` the alpha
    ramps alongside (for compositing over dark images)."""
    rgb = np.asarray(color, np.float64)[:3]
    colors = np.zeros((num_colors, 4))
    colors[:, :3] = np.linspace(0.0, 1.0, num_colors)[:, None] * rgb
    colors[:, 3] = (np.linspace(0.0, max_alpha, num_colors)
                    if transparent else max_alpha)
    return _listed(colors)


def transparent_gradient(color, num_colors: int = 256,
                         max_alpha: float = 1.0):
    """Constant ``color`` with a 0 -> max_alpha alpha ramp."""
    rgb = np.asarray(color, np.float64)[:3]
    colors = np.zeros((num_colors, 4))
    colors[:, :3] = rgb[None]
    colors[:, 3] = np.linspace(0.0, max_alpha, num_colors)
    return _listed(colors)


def normalize_color(mat, vmin=None, vmax=None) -> np.ndarray:
    """Clip ``mat`` to [vmin, vmax] then rescale to [0, 1]
    (NaN-tolerant; NaNs pass through).  A tensor comes to the host."""
    a = np.array(host_array(mat), np.float64)
    if vmin is None:
        vmin = np.nanmin(a)
    if vmax is None:
        vmax = np.nanmax(a)
    a = np.clip(a, vmin, vmax)
    lo, hi = np.nanmin(a), np.nanmax(a)
    return (a - lo) / max(hi - lo, np.finfo(np.float64).tiny)
