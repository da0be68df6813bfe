"""Interactive curation tools, headless-testable.

The counterpart of ``imageanalysis3_tpu/figures/interactive.py``: the same
state, events, ``.npz`` persistence and methods, so a file one package
saves loads in the other.  Behavior targets in the reference:

  * ``visual_tools.py:510-905`` (``imshow_mark_3d_v2``) — the z-scroll
    3D stack browser: xy and z max-projections, right-click to mark or
    delete spot seeds, keyboard-driven automatic seeding ('t') and
    Gaussian fitting ('y'), per-image contrast memory, coordinate
    persistence;
  * ``domain_tools/manual.py:13-233`` (``mark_boundaries``) — manual
    domain-boundary curation on distance maps: right-click to place a
    boundary at the diagonal position, staircase overlay, percentile
    contrast, boundary persistence.

Seeding and fitting run on :class:`SpotBrowser`'s device (the CUDA card
unless ``device="cpu"``): ``seed_view`` sends the zoomed sub-volume there
and calls ``ops.get_seeds`` (``seed_classify`` on the card), ``fit_view``
calls ``ops.iter_fit_seed_points`` (``gather_cubes``' ball entry and
``lm_fit``) on the current image's device copy, made once per image (a
stack given as a tensor on that device is used as it is).
The stacks stay NumPy for drawing; results come back through
``device.host_array``.  All state lives in plain numpy arrays serialized
as ``.npz`` (no pickle); every mutation is a programmatic method
(`add_point`, `seed_view`, `fit_view`, `add_boundary`, ...) with the
matplotlib event handlers as thin shells over them, so the tools run
headless (Agg) and interactively from the same code path.  matplotlib is
imported when a tool is made, not when this module is imported.

Key bindings mirror the reference: a/d cycle images, t seeds, y fits,
x auto-contrast, delete pops the last point, shift toggles
delete-on-click; the boundary marker adds w/e (±20 images) and z/c
(contrast scaling).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import host_array, resolve_device
from ._mpl import pyplot


__all__ = ["SpotBrowser", "BoundaryMarker"]


def _as_stack_list(ims) -> List[np.ndarray]:
    return [host_array(im) for im in ims]


class SpotBrowser:
    """Browse a list of 3D stacks and curate spot seeds/fits.

    Panels: ``ax_xy`` shows the xy max-projection of the current z
    window; ``ax_z`` shows the z max-projection of the current x
    window.  Points are stored as (z, x, y) array coordinates plus the
    owning image index (the reference keeps the same state as four
    parallel Python lists, visual_tools.py:546-548).

    Right-click in ``ax_xy`` adds a point at the window's mid-z;
    right-click in ``ax_z`` re-assigns the nearest point's z.  With
    ``delete_mode`` armed (shift held), right-click removes the nearest
    point in the current view.
    """

    def __init__(self, ims: Sequence[np.ndarray],
                 image_names: Optional[Sequence[str]] = None,
                 save_file: Optional[str] = None,
                 fig=None, marker_size: int = 8,
                 clim: Tuple[Optional[float], Optional[float]] = (None, None),
                 seed_kwargs: Optional[Dict] = None,
                 fit_kwargs: Optional[Dict] = None,
                 device=None):
        plt = pyplot()
        #: where seeding and fitting run (the CUDA card unless "cpu")
        self.device = resolve_device(device)
        self.ims = _as_stack_list(ims)
        # a stack already on the device is its own device copy
        self._device_ims: Dict[int, torch.Tensor] = {
            i: im.to(torch.float32) for i, im in enumerate(ims)
            if isinstance(im, torch.Tensor) and im.device == self.device}
        if not self.ims:
            raise ValueError("need at least one image")
        self.image_names = list(image_names) if image_names is not None \
            else [f"Image {i + 1}" for i in range(len(self.ims))]
        self.save_file = save_file
        self.seed_kwargs = dict(seed_kwargs or {})
        self.fit_kwargs = dict(fit_kwargs or {})

        # curation state: (N, 3) float zxy + (N,) image index
        self.points = np.zeros((0, 3), np.float64)
        self.point_image = np.zeros((0,), np.int64)
        self.fits: Dict[int, np.ndarray] = {}   # image index -> (M, 11)
        self.delete_mode = False
        self.index_im = 0
        self._clim_memory: Dict[int, Tuple[float, float]] = {}

        if save_file is not None and os.path.exists(save_file):
            self.load(save_file)

        self.fig = fig if fig is not None else plt.figure(figsize=(4, 5))
        self.ax_xy = self.fig.add_subplot(2, 1, 1)
        self.ax_z = self.fig.add_subplot(2, 1, 2)
        im0 = self.ims[self.index_im]
        self._im_xy = self.ax_xy.imshow(im0.max(axis=0), cmap="gray",
                                        interpolation="nearest")
        self._im_z = self.ax_z.imshow(im0.max(axis=1), cmap="gray",
                                      interpolation="nearest")
        lo = np.min(im0) if clim[0] is None else clim[0]
        hi = np.max(im0) if clim[1] is None else clim[1]
        self._default_clim = (float(lo), float(hi))
        self._marks_xy, = self.ax_xy.plot(
            [], [], "o", markersize=marker_size, markeredgewidth=1,
            markeredgecolor="y", markerfacecolor="none")
        self._marks_z, = self.ax_z.plot(
            [], [], "o", markersize=marker_size, markeredgewidth=1,
            markeredgecolor="y", markerfacecolor="none")
        self.fig.canvas.mpl_connect("button_press_event", self.on_click)
        self.fig.canvas.mpl_connect("key_press_event", self.on_key)
        self.fig.canvas.mpl_connect("key_release_event", self.on_key_release)
        self.set_image(0)

    # -- view state ------------------------------------------------------

    @property
    def current_image(self) -> np.ndarray:
        return self.ims[self.index_im]

    def view_limits(self) -> Tuple[int, int, int, int, int, int]:
        """(z_lo, z_hi, x_lo, x_hi, y_lo, y_hi) of the zoomed view,
        clipped to the stack (reference get_limits,
        visual_tools.py:810-821)."""
        im = self.current_image
        y_lo, y_hi = self.ax_xy.get_xlim()
        x_hi, x_lo = self.ax_xy.get_ylim()       # imshow y axis inverted
        z_hi, z_lo = self.ax_z.get_ylim()
        z_lo = max(int(z_lo), 0)
        z_hi = min(int(np.ceil(z_hi)), im.shape[0])
        x_lo = max(int(x_lo), 0)
        x_hi = min(int(np.ceil(x_hi)), im.shape[1])
        y_lo = max(int(y_lo), 0)
        y_hi = min(int(np.ceil(y_hi)), im.shape[2])
        return z_lo, z_hi, x_lo, x_hi, y_lo, y_hi

    def _in_view(self) -> np.ndarray:
        z0, z1, x0, x1, y0, y1 = self.view_limits()
        p = self.points
        return ((self.point_image == self.index_im)
                & (p[:, 0] >= z0) & (p[:, 0] < z1)
                & (p[:, 1] >= x0) & (p[:, 1] < x1)
                & (p[:, 2] >= y0) & (p[:, 2] < y1))

    def set_image(self, index: int) -> None:
        prev_shape = self.current_image.shape
        self.index_im = index % len(self.ims)
        im = self.current_image
        if im.shape != prev_shape or not hasattr(self, "_shown_shape"):
            # reset the zoom to the new image's full extent — stale
            # limits from a differently-sized stack would otherwise
            # crop the projections and _in_view() silently
            self._shown_shape = im.shape
            self.ax_xy.set_xlim(-0.5, im.shape[2] - 0.5)
            self.ax_xy.set_ylim(im.shape[1] - 0.5, -0.5)
            self.ax_z.set_xlim(-0.5, im.shape[2] - 0.5)
            self.ax_z.set_ylim(im.shape[0] - 0.5, -0.5)
        z0, z1, x0, x1, _, _ = self.view_limits()
        self._im_xy.set_data(im[z0:z1].max(axis=0))
        self._im_z.set_data(im[:, x0:x1].max(axis=1))
        lo, hi = self._clim_memory.get(self.index_im, self._default_clim)
        self._im_xy.set_clim(lo, hi)
        self._im_z.set_clim(lo, hi)
        self.ax_xy.set_title(self.image_names[self.index_im])
        self._redraw_marks()

    def autoscale(self) -> Tuple[float, float]:
        """Contrast to min/max of the zoomed subvolume (reference 'x',
        visual_tools.py:757-765)."""
        z0, z1, x0, x1, y0, y1 = self.view_limits()
        sub = self.current_image[z0:z1, x0:x1, y0:y1]
        lo, hi = float(sub.min()), float(sub.max())
        self._clim_memory[self.index_im] = (lo, hi)
        self._im_xy.set_clim(lo, hi)
        self._im_z.set_clim(lo, hi)
        self.fig.canvas.draw_idle()
        return lo, hi

    # -- point curation ---------------------------------------------------

    def add_point(self, z: float, x: float, y: float,
                  image_index: Optional[int] = None) -> None:
        idx = self.index_im if image_index is None else image_index
        self.points = np.vstack([self.points, [[z, x, y]]])
        self.point_image = np.append(self.point_image, idx)
        self.save()
        self._redraw_marks()

    def pop_point(self) -> None:
        if len(self.points):
            self.points = self.points[:-1]
            self.point_image = self.point_image[:-1]
            self.save()
            self._redraw_marks()

    def delete_nearest(self, x: float, y: float) -> Optional[int]:
        """Remove the in-view point nearest in the xy plane; returns its
        former row index (reference delete branch,
        visual_tools.py:598-619)."""
        keep = self._in_view()
        if not keep.any():
            return None
        rows = np.flatnonzero(keep)
        d = (np.abs(self.points[rows, 1] - x)
             + np.abs(self.points[rows, 2] - y))
        victim = rows[int(np.argmin(d))]
        self.points = np.delete(self.points, victim, axis=0)
        self.point_image = np.delete(self.point_image, victim)
        self.save()
        self._redraw_marks()
        return int(victim)

    def set_nearest_z(self, y: float, z: float) -> None:
        """Re-assign z of the in-view point nearest in y (the z-panel
        click, visual_tools.py:628-639)."""
        keep = self._in_view()
        if not keep.any():
            return
        rows = np.flatnonzero(keep)
        victim = rows[int(np.argmin(np.abs(self.points[rows, 2] - y)))]
        self.points[victim, 0] = z
        self.save()
        self._redraw_marks()

    def image_points(self, index: Optional[int] = None) -> np.ndarray:
        idx = self.index_im if index is None else index
        return self.points[self.point_image == idx]

    def _replace_image_points(self, coords_zxy: np.ndarray) -> None:
        keep = self.point_image != self.index_im
        self.points = np.vstack([self.points[keep],
                                 np.asarray(coords_zxy, np.float64)])
        self.point_image = np.append(
            self.point_image[keep],
            np.full(len(coords_zxy), self.index_im, np.int64))
        self.save()
        self._redraw_marks()

    # -- kernels ----------------------------------------------------------

    def _device_image(self) -> torch.Tensor:
        """The current image as float32 on the browser's device, uploaded
        once per image."""
        idx = self.index_im
        if idx not in self._device_ims:
            self._device_ims[idx] = torch.as_tensor(
                self.current_image, device=self.device).to(torch.float32)
        return self._device_ims[idx]

    def seed_view(self, **overrides) -> np.ndarray:
        """Replace the current image's points with automatic seeds from
        the zoomed subvolume ('t'; the reference calls its scipy seeder,
        visual_tools.py:873-890 — here ``ops.get_seeds`` on the browser's
        device)."""
        from ..ops import get_seeds

        z0, z1, x0, x1, y0, y1 = self.view_limits()
        sub = torch.as_tensor(
            np.ascontiguousarray(self.current_image[z0:z1, x0:x1, y0:y1]),
            device=self.device).to(torch.float32)
        kwargs = {**self.seed_kwargs, **overrides}
        seeds = get_seeds(sub, **kwargs)
        valid = host_array(seeds.valid).astype(bool)
        coords = host_array(seeds.coords).astype(np.float64)[valid]
        coords += [z0, x0, y0]
        self._replace_image_points(coords)
        return coords

    def fit_view(self, **overrides) -> np.ndarray:
        """Fit 3D Gaussians at the current image's in-view points ('y';
        reference fit_seed_points, visual_tools.py:824-856), with
        ``ops.iter_fit_seed_points`` on the browser's device.  Points are
        replaced by fitted centers; the full 11-column rows are kept in
        ``self.fits[index_im]``."""
        from ..ops import iter_fit_seed_points

        sel = self._in_view()
        if not sel.any():
            return np.zeros((0, 11), np.float32)
        seeds = np.round(self.points[sel]).astype(np.float32)
        res = iter_fit_seed_points(
            self._device_image(),
            torch.as_tensor(seeds, device=self.device),
            torch.ones(len(seeds), dtype=torch.bool, device=self.device),
            **{**self.fit_kwargs, **overrides})
        ok = host_array(res.valid).astype(bool)
        rows = host_array(res.spots)[ok]
        keep = ~sel & (self.point_image == self.index_im)
        others = self.points[self.point_image != self.index_im]
        other_ids = self.point_image[self.point_image != self.index_im]
        kept = self.points[keep]
        self.points = np.vstack([others, kept, rows[:, 1:4]])
        self.point_image = np.concatenate(
            [other_ids, np.full(len(kept), self.index_im, np.int64),
             np.full(len(rows), self.index_im, np.int64)])
        self.fits[self.index_im] = rows
        self.save()
        self._redraw_marks()
        return rows

    # -- persistence (npz, no pickle) --------------------------------------

    def save(self, path: Optional[str] = None) -> None:
        path = path or self.save_file
        if path is None:
            return
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        payload = {"points": self.points, "point_image": self.point_image}
        for k, v in self.fits.items():
            payload[f"fits_{k}"] = v
        np.savez(path, **payload)

    def load(self, path: str) -> None:
        data = np.load(path)
        self.points = np.asarray(data["points"], np.float64)
        self.point_image = np.asarray(data["point_image"], np.int64)
        self.fits = {int(k.split("_", 1)[1]): data[k]
                     for k in data.files if k.startswith("fits_")}

    # -- matplotlib event shells -------------------------------------------

    def on_click(self, event) -> None:
        if getattr(event, "button", None) != 3:
            return
        if event.xdata is None or event.ydata is None:
            return
        if event.inaxes is self.ax_xy:
            if self.delete_mode:
                self.delete_nearest(event.ydata, event.xdata)
            else:
                z0, z1, *_ = self.view_limits()
                self.add_point((z0 + z1) / 2.0, event.ydata, event.xdata)
        elif event.inaxes is self.ax_z:
            self.set_nearest_z(event.xdata, event.ydata)

    def on_key(self, event) -> None:
        key = getattr(event, "key", None)
        if key == "d":
            self.set_image(self.index_im + 1)
        elif key == "a":
            self.set_image(self.index_im - 1)
        elif key == "t":
            self.seed_view()
        elif key == "y":
            self.fit_view()
        elif key == "x":
            self.autoscale()
        elif key == "s":
            self.save()
        elif key == "delete":
            self.pop_point()
        elif key == "shift":
            self.delete_mode = True

    def on_key_release(self, event) -> None:
        if getattr(event, "key", None) == "shift":
            self.delete_mode = False

    def _redraw_marks(self) -> None:
        sel = self._in_view()
        p = self.points[sel]
        self._marks_xy.set_data(p[:, 2], p[:, 1])
        self._marks_z.set_data(p[:, 2], p[:, 0])
        self.fig.canvas.draw_idle()


class BoundaryMarker:
    """Manually curate domain boundaries on per-cell distance maps.

    The reference navigates a list of single-cell distance maps and
    records one scalar per click — the boundary's diagonal position
    ``(x + y) / 2`` — rendering the running boundary set as a staircase
    over the map (domain_tools/manual.py:89-157).  Same model here,
    stored as one float array plus the owning map index.
    """

    def __init__(self, maps: Sequence[np.ndarray],
                 names: Optional[Sequence[str]] = None,
                 save_file: Optional[str] = None, fig=None,
                 clim: Tuple[float, float] = (0.0, 1000.0),
                 scale_percentile: float = 95.0):
        self.maps = _as_stack_list(maps)
        if not self.maps:
            raise ValueError("need at least one map")
        self.names = list(names) if names is not None \
            else [f"Image {i + 1}" for i in range(len(self.maps))]
        self.save_file = save_file
        self.scale_percentile = float(scale_percentile)

        self.positions = np.zeros((0,), np.float64)
        self.map_index = np.zeros((0,), np.int64)
        self.delete_mode = False
        self.index_im = 0
        self._clim_memory: Dict[int, Tuple[float, float]] = {}
        self._default_clim = (float(min(clim)), float(max(clim)))

        if save_file is not None and os.path.exists(save_file):
            self.load(save_file)

        plt = pyplot()
        self.fig = fig if fig is not None else plt.figure(figsize=(4, 4))
        self.ax = self.fig.add_subplot(1, 1, 1)
        self._imshow = self.ax.imshow(self.maps[0], cmap="seismic_r",
                                      interpolation="nearest")
        self._imshow.set_clim(*self._default_clim)
        self._stairs, = self.ax.plot([], [], "g-", linewidth=2.5)
        self.fig.canvas.mpl_connect("button_press_event", self.on_click)
        self.fig.canvas.mpl_connect("key_press_event", self.on_key)
        self.fig.canvas.mpl_connect("key_release_event", self.on_key_release)
        self.set_image(0)

    # -- state -------------------------------------------------------------

    def boundaries(self, index: Optional[int] = None) -> np.ndarray:
        """Sorted boundary positions of one map (excluding 0 / n)."""
        idx = self.index_im if index is None else index
        return np.sort(self.positions[self.map_index == idx])

    def domain_starts(self, index: Optional[int] = None) -> np.ndarray:
        """Integer domain start indices [0, b1, b2, ...] — the format
        `analysis.domains` consumes."""
        b = np.round(self.boundaries(index)).astype(int)
        n = self.maps[self.index_im if index is None else index].shape[0]
        b = b[(b > 0) & (b < n)]
        return np.concatenate([[0], np.unique(b)])

    def add_boundary(self, x: float, y: float,
                     index: Optional[int] = None) -> float:
        """Record a boundary at the diagonal position (x + y) / 2
        (reference onclick, domain_tools/manual.py:108-111)."""
        idx = self.index_im if index is None else index
        pos = (float(x) + float(y)) / 2.0
        self.positions = np.append(self.positions, pos)
        self.map_index = np.append(self.map_index, idx)
        self.save()
        self._redraw()
        return pos

    def delete_nearest(self, x: float, y: float) -> Optional[int]:
        sel = self.map_index == self.index_im
        if not sel.any():
            return None
        rows = np.flatnonzero(sel)
        target = (float(x) + float(y)) / 2.0
        victim = rows[int(np.argmin(np.abs(self.positions[rows] - target)))]
        self.positions = np.delete(self.positions, victim)
        self.map_index = np.delete(self.map_index, victim)
        self.save()
        self._redraw()
        return int(victim)

    def pop_boundary(self) -> None:
        if len(self.positions):
            self.positions = self.positions[:-1]
            self.map_index = self.map_index[:-1]
            self.save()
            self._redraw()

    def set_image(self, index: int) -> None:
        self.index_im = index % len(self.maps)
        self._imshow.set_data(self.maps[self.index_im])
        lo, hi = self._clim_memory.get(self.index_im, self._default_clim)
        self._imshow.set_clim(lo, hi)
        self.fig.suptitle(self.names[self.index_im])
        self._redraw()

    def autoscale(self) -> Tuple[float, float]:
        """Percentile contrast of the current map (reference
        auto_scale, domain_tools/manual.py:179-191)."""
        m = np.asarray(self.maps[self.index_im], float)
        vals = m[np.isfinite(m)]
        lo = float(np.percentile(vals, 100.0 - self.scale_percentile))
        hi = float(np.percentile(vals, self.scale_percentile))
        self._clim_memory[self.index_im] = (lo, hi)
        self._imshow.set_clim(lo, hi)
        self.fig.canvas.draw_idle()
        return lo, hi

    def scale(self, factor: float) -> None:
        lo, hi = self._clim_memory.get(self.index_im, self._default_clim)
        self._clim_memory[self.index_im] = (lo * factor, hi * factor)
        self._imshow.set_clim(lo * factor, hi * factor)
        self.fig.canvas.draw_idle()

    def staircase(self, index: Optional[int] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """The overlay polyline: boundaries padded with 0 and n, each
        segment drawn as a step (reference update_point_plot,
        domain_tools/manual.py:142-157)."""
        idx = self.index_im if index is None else index
        n = self.maps[idx].shape[0]
        b = np.concatenate([[0.0], self.boundaries(idx), [float(n)]])
        xs, ys = [], []
        for i, v in enumerate(b):
            xs.append(v)
            ys.append(v)
            if i + 1 < len(b):
                xs.append(v)
                ys.append(b[i + 1])
        return np.asarray(xs), np.asarray(ys)

    # -- persistence --------------------------------------------------------

    def save(self, path: Optional[str] = None) -> None:
        path = path or self.save_file
        if path is None:
            return
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        np.savez(path, positions=self.positions,
                 map_index=self.map_index,
                 names=np.asarray([str(n) for n in self.names]))

    def load(self, path: str) -> None:
        data = np.load(path)
        self.positions = np.asarray(data["positions"], np.float64)
        self.map_index = np.asarray(data["map_index"], np.int64)

    # -- matplotlib event shells ---------------------------------------------

    def on_click(self, event) -> None:
        if getattr(event, "button", None) != 3 or event.inaxes is not self.ax:
            return
        if event.xdata is None or event.ydata is None:
            return
        if self.delete_mode:
            self.delete_nearest(event.xdata, event.ydata)
        else:
            self.add_boundary(event.xdata, event.ydata)

    def on_key(self, event) -> None:
        key = getattr(event, "key", None)
        if key == "d":
            self.set_image(self.index_im + 1)
        elif key == "a":
            self.set_image(self.index_im - 1)
        elif key == "e":
            self.set_image(self.index_im + 20)
        elif key == "w":
            self.set_image(self.index_im - 20)
        elif key == "x":
            self.autoscale()
        elif key == "z":
            self.scale(1.1)
        elif key == "c":
            self.scale(1.0 / 1.1)
        elif key == "delete":
            self.pop_boundary()
        elif key == "shift":
            self.delete_mode = True

    def on_key_release(self, event) -> None:
        if getattr(event, "key", None) == "shift":
            self.delete_mode = False

    def _redraw(self) -> None:
        xs, ys = self.staircase()
        self._stairs.set_data(xs, ys)
        self.fig.canvas.draw_idle()
