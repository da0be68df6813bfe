"""Legacy-pipeline compatibility layer: the Cell_List / Cell_Data workflow.

The counterpart of ``imageanalysis3_tpu/legacy.py``: the same classes,
methods and ``.npz`` cell checkpoints (a file either package writes loads
in the other).  Behavior target: reference classes/__init__.py:817-4513 —
the first-generation per-cell pipeline notebooks drive: load metadata
(`_load_color_info` etc.), crop candidate images (`_crop_images`),
identify chromosomes (`_identify_chromosomes`,
`_get_chromosomes_for_cells`), multi-fit
(`_multi_fitting_for_chromosome`), pick spots (naive/dynamic/EM,
`_pick_spots` / `_pick_spots_for_cells`), screen by intensity p-value
(`_get_intensity_stats` / `_p_value_filter`), generate distance maps,
call domains (`_domain_calling` / `_batch_domain_calling`), merge RNA
results into DNA cells (`_merge_RNA_to_DNA`), checkpoint cells
(`_save_to_file` / `_load_from_file`, `_save_cells_to_files` /
`_load_cells_from_files`), and reduce population maps
(median/mean/contact, `_calculate_population_map`).  This module keeps
that *workflow shape* as a compatibility facade over the port's engine so
reference users can port notebooks method-by-method; new code should use
pipeline.FieldOfView / ExperimentDriver directly.

Where the JAX package computes with ``jnp``, the port computes with
tensors on the cell's device: :class:`CellData` and :class:`CellList`
take ``device`` (the CUDA card unless ``device="cpu"``; :class:`CellList`
hands it to its ``ExperimentDriver``).  Picking, distance maps, domain
calls, the label vote, the chromosome seeding and the multi-fit
(``seed_classify``, ``gather_cubes`` and ``lm_fit`` on the card) run
there; host results are NumPy as in the JAX package.  The store is read
through ``FovStore``'s public methods only (``ids``, ``drifts``,
``drift_flags``, ``load_image``, ``load_segmentation``,
``load_all_spots``), so the facade works on both store backends (an
HDF5 file, or the ``.npy`` directory where h5py is missing).
``_spot_finding_for_cells`` reads and uploads each region image once per
FOV and fits every cell of the FOV on it; ``_crop_image_for_cells`` reads
each region image once per FOV and crops every cell from it;
``_load_segmentation`` finds every cell's box in one pass over the FOV's
labels.  Each cell's result equals that of a per-cell call.

Three faults of the JAX file are put right here, following ImageAnalysis3
rather than the JAX package:

* ``_generate_dependent_maps``: flags are ternary, as in the reference
  (classes/__init__.py:2136-2161): ``f = np.max(flag)``; ``f > 0`` puts the
  chromosome in the 'on' pool, ``f < 0`` in 'off', ``f == 0`` in neither.
  The JAX package splits by truthiness (-1 lands in 'on', 0 in 'off').
* ``_translate_chromosome_coords``: the FOV extent comes from the driver's
  ``cfg.image_size``; without one the FOV is unbounded, so no crop counts
  as touching the high border.  The JAX package guesses the extent from
  the two crops, which re-anchors nearly every interior cell.
* ``_translate_chromosome_coords`` overwrites a target cell's coordinates
  by default (``overwrite=True``), as the reference's ``force=True``; the
  JAX package keeps existing ones.

Deliberate differences (as in the JAX package): no pickled `cell_info`
state (cell checkpoints are `.npz`, the store is the pipeline
checkpoint), no multiprocessing pools (the device is the parallelism),
segmentation comes from segmentation.segment_nuclei or imported masks
rather than the retired DAPI watershed, and cells map 1:1 to FOVs in
`_create_cells` (per-segmented-cell gating via `_create_cells_fov` or
analysis.partition).  Methods NOT ported, each with its reason:
`_pick_cell_segmentations` / `_update_cell_segmentations` /
`_pick_chromosome_manual` / `_add_round_marker` (matplotlib click GUIs;
see figures.interactive BoundaryMarker/SpotBrowser),
`_translate_old_segmentations`' raw-`.dax` re-correction branch (the
driver owns raw correction), the
combo/`Encoding_Group` old-generation decode path incl. `_save_group`
(replaced by decode.merfish), and the multiprocessing-pool plumbing
`_init_unique_pool` / `_fit_single_image` / `_pick_spot_in_batch` /
`_load_cell_in_batch` / `_save_cell_in_batch` /
`_merge_RNA_to_DNA_in_batch` (pool workers that only forward kwargs to
the per-cell methods ported here; batched device dispatch replaces the
pool, so the batch APIs are the CellList methods themselves).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .analysis.distmap import distance_map
from .config import DEFAULT_PIXEL_SIZE_NM, ExperimentConfig
from .decode.picking import (build_candidate_table, em_pick_spots,
                             dynamic_pick_spots, naive_pick_spots)
from .device import as_tensor, host_array, resolve_device
from .io.store import FovStore
from .pipeline.experiment import ExperimentDriver

#: (lo, hi) zxy bounding box of one cell's label, hi exclusive
Box = Tuple[np.ndarray, np.ndarray]


def _border_aware_centers(s_lo: int, s_hi: int, t_lo: int, t_hi: int,
                          fov_lim: float, border_lim: int
                          ) -> tuple:
    """Per-axis rotation centers for chromosome-coordinate carry-over
    (reference visual_tools.translate_chromosome_coordinates:2915-2950),
    on absolute FOV coordinates: a crop clipped by the FOV edge has a
    biased midpoint, so the center is re-anchored to the in-FOV edge
    using the unclipped partner's half-width (or the larger half-width
    when both are clipped).  ``fov_lim`` may be ``inf`` (no high
    border)."""
    s_mid, t_mid = (s_lo + s_hi) / 2.0, (t_lo + t_hi) / 2.0
    if s_lo < border_lim and t_lo < border_lim:
        ct = max(s_mid - s_lo, t_mid - t_lo)
        return s_hi - ct, t_hi - ct
    if s_lo < border_lim:
        ct = t_mid - t_lo
        return s_hi - ct, t_hi - ct
    if t_lo < border_lim:
        ct = s_mid - s_lo
        return s_hi - ct, t_hi - ct
    if s_hi > fov_lim - border_lim and t_hi > fov_lim - border_lim:
        ct = max(s_mid - s_lo, t_mid - t_lo)
        return s_lo + ct, t_lo + ct
    if s_hi > fov_lim - border_lim:
        ct = t_mid - t_lo
        return s_lo + ct, t_lo + ct
    if t_hi > fov_lim - border_lim:
        ct = s_mid - s_lo
        return s_lo + ct, t_lo + ct
    return s_mid, t_mid


def _label_boxes(labels: np.ndarray, device) -> Dict[int, Box]:
    """cell id -> its label's unpadded (lo, hi) zxy box, from one pass
    over a (Z, X, Y) label volume on `device` (2D labels count as one
    plane)."""
    from .ops.cell_fitting import segmentation_bounding_boxes

    lab = np.asarray(labels)
    if lab.ndim == 2:
        lab = lab[None]
    return segmentation_bounding_boxes(
        torch.as_tensor(lab.astype(np.int32, copy=False), device=device),
        pad=0)


def _xy_crop(box: Box, extend_dim: int, xy_shape=None) -> np.ndarray:
    """[[x0, x1], [y0, y1]] of a cell's box extended by `extend_dim`,
    clipped at 0 and (when given) at the plane's shape."""
    (_, x_lo, y_lo), (_, x_hi, y_hi) = box
    hi = (np.inf, np.inf) if xy_shape is None else xy_shape
    return np.array([[max(int(x_lo) - extend_dim, 0),
                      int(min(int(x_hi) + extend_dim, hi[0]))],
                     [max(int(y_lo) - extend_dim, 0),
                      int(min(int(y_hi) + extend_dim, hi[1]))]])


def _cell_box(labels: np.ndarray, cell_id: int) -> Box:
    """One cell's unpadded zxy box from its mask (a host pass)."""
    lab = np.asarray(labels)
    mask = lab == int(cell_id)
    if not mask.any():
        raise ValueError(f"cell {cell_id} absent from segmentation")
    xs, ys = np.where(mask.any(axis=0) if lab.ndim == 3 else mask)
    return (np.array([0, xs.min(), ys.min()]),
            np.array([lab.shape[0] if lab.ndim == 3 else 1,
                      xs.max() + 1, ys.max() + 1]))


class CellData:
    """One cell's picking workflow (reference Cell_Data,
    classes/__init__.py:2371-4443).  `device`: where its picking, maps,
    domain calls and fits run (the CUDA card unless ``"cpu"``)."""

    def __init__(self, cand_spots_by_region: Dict[int, np.ndarray],
                 chrom_coords: Optional[Sequence[np.ndarray]] = None,
                 pixel_size_nm=DEFAULT_PIXEL_SIZE_NM,
                 fov_name: Optional[str] = None,
                 cell_id: Optional[int] = None,
                 device=None):
        self._device = resolve_device(device)
        self.cand_spots = cand_spots_by_region
        self.chrom_coords = (None if chrom_coords is None
                             else [np.asarray(c) for c in chrom_coords])
        self.pixel_size = np.asarray(pixel_size_nm)
        self.fov_name = fov_name
        self.cell_id = cell_id
        self.picked: Dict[int, dict] = {}

    # -- picking (reference _pick_spots, :3733-4038) -----------------------

    def _pick_spots(self, method: str = "EM",
                    **kwargs) -> List[np.ndarray]:
        """Pick one trace per chromosome; methods 'naive' | 'dynamic' |
        'EM' (the reference's three pickers), on the cell's device."""
        dev = self._device
        cand, valid, ids = build_candidate_table(self.cand_spots)
        cand_t = torch.as_tensor(cand, device=dev)
        valid_t = torch.as_tensor(valid, device=dev)
        ids_t = torch.as_tensor(ids, device=dev)
        centers = (self.chrom_coords if self.chrom_coords
                   else [None])
        traces = []
        for ci, center in enumerate(centers):
            ctr = (None if center is None else torch.as_tensor(
                np.asarray(center, np.float32), device=dev))
            if method.upper() == "EM":
                res = em_pick_spots(cand_t, valid_t, ids_t,
                                    chrom_center=ctr, device=dev, **kwargs)
                trace = host_array(res.trace)
                self.picked[ci] = {"sel_idx": host_array(res.sel_idx),
                                   "scores": host_array(res.scores)}
            elif method.lower() == "dynamic":
                # intensity-only spot scores; continuity comes from the DP
                sc = torch.where(valid_t, torch.log(torch.clamp_min(
                    cand_t[..., 0], 1e-6)), float("-inf"))
                sel, _ = dynamic_pick_spots(cand_t, valid_t, sc, ids_t,
                                            500.0, **kwargs)
                sel = host_array(sel)
                trace = cand[np.arange(len(ids)), sel]
                has = valid[np.arange(len(ids)), sel]
                trace = np.where(has[:, None], trace, np.nan)
                self.picked[ci] = {"sel_idx": sel}
            else:
                tr, has = naive_pick_spots(cand_t, valid_t, ctr, device=dev)
                trace = host_array(tr)
                self.picked[ci] = {}
            traces.append(trace)
        self.picked_traces = traces
        return traces

    # -- distance maps (reference _generate_distance_map, :4123-4273) ------

    def _zxys_nm(self, trace: np.ndarray) -> np.ndarray:
        return trace[:, 1:4] * self.pixel_size[None]

    def _generate_distance_map(self) -> List[np.ndarray]:
        if not hasattr(self, "picked_traces"):
            self._pick_spots()
        maps = []
        for trace in self.picked_traces:
            zxys = torch.as_tensor(self._zxys_nm(trace), dtype=torch.float32,
                                   device=self._device)
            maps.append(host_array(distance_map(zxys)))
        self.distance_maps = maps
        return maps

    # -- per-cell image crops (reference _crop_images, :2780-2962) ---------

    @staticmethod
    def _crop_images(store: FovStore, data_type: str,
                     segmentation_labels: np.ndarray, cell_id: int,
                     extend_dim: int = 20) -> Dict[int, np.ndarray]:
        """Crop every stored region image to this cell's xy bounding box
        (full z), extended by `extend_dim` pixels.

        Behavior target: Cell_Data._crop_images
        (classes/__init__.py:2780-2962), which slices each round's image
        to the cell's segmentation box.  Difference by design: the
        reference crops raw rounds and drift-translates each crop; here
        the store's corrected images are sliced as they were saved (the
        driver saves them corrected but not drift-warped), so the crop is
        a plain box slice.  Requires the driver to have run with
        save_images=True.
        """
        box = _cell_box(host_array(segmentation_labels), cell_id)
        (x0, x1), (y0, y1) = _xy_crop(box, extend_dim)
        return _crop_regions(store, data_type, {0: (x0, x1, y0, y1)})[0]

    @staticmethod
    def _crop_images_from_disk(driver, fov_name: str, data_type: str,
                               segmentation_labels: np.ndarray,
                               cell_id: int, extend_dim: int = 20,
                               region_ids=None) -> Dict[int, np.ndarray]:
        """Disk variant of :meth:`_crop_images` for runs without stored
        corrected images: window-read each region's raw movie around this
        cell's bounding box and drift-correct the crop
        (ExperimentDriver.load_region_crops; reference Cell_Data
        _crop_images raw path, classes/__init__.py:2780-2962)."""
        box = _cell_box(host_array(segmentation_labels), cell_id)
        lims = _xy_crop(box, extend_dim).tolist()
        return driver.load_region_crops(fov_name, lims, data_type,
                                        region_ids=region_ids)

    # -- chromosome identification (reference _identify_chromosomes,
    #    :3504-3550) -------------------------------------------------------

    def _identify_chromosomes(self, chrom_im: np.ndarray,
                              nucleus_labels: Optional[np.ndarray] = None,
                              expected_per_nucleus: int = 2,
                              th_seed: Optional[float] = None,
                              **find_kwargs) -> np.ndarray:
        """Seed chromosome centers in this cell's chromosome image and
        store them as `chrom_coords` (reference _identify_chromosomes,
        classes/__init__.py:3504-3550: gaussian blur + seeding inside the
        segmentation label).  Delegates to the per-nucleus adaptive
        seeding (segmentation.chromosome.find_candidate_chromosomes) on
        the cell's device."""
        from .segmentation.chromosome import find_candidate_chromosomes

        chrom_im = host_array(chrom_im)
        if nucleus_labels is None:
            nucleus_labels = np.ones(chrom_im.shape, np.int32)
        if th_seed is None:
            th_seed = float(3.0 * np.std(chrom_im))
        coords, _, _ = find_candidate_chromosomes(
            chrom_im, host_array(nucleus_labels),
            expected_per_nucleus=expected_per_nucleus,
            th_seed=th_seed, device=self._device, **find_kwargs)
        self.chrom_coords = [np.asarray(c) for c in coords]
        return np.asarray(coords)

    # -- per-chromosome multi-fitting (reference
    #    _multi_fitting_for_chromosome, :3642-3730) ------------------------

    def _multi_fitting_for_chromosome(self, ims_by_region: Dict[int,
                                                                np.ndarray],
                                      fit_window: int = 40,
                                      th_seed: float = 300.0,
                                      max_seed_count: int = 10,
                                      **fit_kwargs) -> Dict[int, np.ndarray]:
        """Fit candidate spots in a window around every chromosome center
        in every region image, replacing `cand_spots`.

        Behavior target: Cell_Data._multi_fitting_for_chromosome
        (classes/__init__.py:3642-3730): per chromosome, crop a
        `_fit_window` box around the chromosome coordinate, seed + LM-fit
        it, collect per-region candidate lists.  Here the crops of one
        region fit one after another on the cell's device
        (ops.cell_fitting.fit_spots_around_centers: ``seed_classify``,
        ``gather_cubes`` and ``lm_fit`` on the card); a NumPy image goes
        there, a tensor is used where it lies.  Requires `chrom_coords`
        (run `_identify_chromosomes` first)."""
        from .ops.cell_fitting import fit_spots_around_centers

        if not self.chrom_coords:
            raise AttributeError("no chrom_coords; run "
                                 "_identify_chromosomes first")
        centers = np.asarray(self.chrom_coords, float)
        w = int(fit_window)
        out: Dict[int, np.ndarray] = {}
        for rid, im in ims_by_region.items():
            im = as_tensor(im, self._device)
            zdim = min(int(im.shape[0]), w)
            spots, valid = fit_spots_around_centers(
                im, centers, crop_size=(zdim, w, w), th_seed=th_seed,
                max_num_seeds=max_seed_count, device=self._device,
                **fit_kwargs)
            spots, valid = host_array(spots), host_array(valid).astype(bool)
            out[int(rid)] = np.concatenate(
                [s[v] for s, v in zip(spots, valid)]) if valid.any() \
                else np.zeros((0, spots.shape[-1]), np.float32)
        self.cand_spots = out
        return out

    # -- background levels (reference _calculate_background, :3591-3641) ---

    @staticmethod
    def _calculate_background(ims_by_channel: Dict,
                              function_type: str = "median",
                              num_per_channel: int = 20) -> Dict:
        """Per-channel background level: reduce up to `num_per_channel`
        images per channel with nan-median/mean, then take the median of
        the reduced image (reference Cell_Data._calculate_background,
        classes/__init__.py:3591-3641).  `ims_by_channel`: channel ->
        list of 3D arrays (host NumPy, as in the JAX package)."""
        if function_type not in ("median", "mean"):
            raise KeyError(f"function_type {function_type!r} not in "
                           f"median/mean")
        reduce = np.nanmedian if function_type == "median" else np.nanmean
        out = {}
        for ch, ims in ims_by_channel.items():
            ims = [np.asarray(host_array(im), np.float32)
                   for im in ims[:num_per_channel]]
            if not ims:
                continue
            out[ch] = float(np.median(reduce(np.stack(ims), axis=0)))
        return out

    # -- completeness check (reference _check_full_set, :2963-3011) --------

    def _check_full_set(self, expected_ids: Sequence[int]) -> bool:
        """True when every expected region id has a (possibly empty)
        candidate-spot entry (reference Cell_Data._check_full_set,
        classes/__init__.py:2963-3011, which checks the saved rounds file
        against the color-usage id list)."""
        return all(int(i) in {int(k) for k in self.cand_spots}
                   for i in expected_ids)

    # -- drift completeness (reference _check_drift, :2687-2706) -----------

    def _check_drift(self, expected_ids: Optional[Sequence[int]] = None
                     ) -> bool:
        """True when a drift table is attached and covers every expected
        region with a consensus-quality vector.

        Behavior target: Cell_Data._check_drift (classes/__init__.py:
        2687-2706), which verifies the drift dict holds an entry for
        every Color_Usage folder.  Here the table is the store's
        per-region `drifts`/`drift_flags` arrays (attached by
        CellList._load_drift); flag 0 = crop consensus, nonzero =
        fallback (suspicious) — a fallback drift counts as missing, the
        reference's 'load better, although de novo is allowed' stance."""
        if not hasattr(self, "drifts") or not hasattr(self, "drift_ids"):
            return False
        ids = {int(i) for i in self.drift_ids}
        want = (ids if expected_ids is None
                else {int(i) for i in expected_ids})
        if not want.issubset(ids):
            return False
        flags = getattr(self, "drift_flags", np.zeros(len(self.drift_ids)))
        by_id = {int(i): int(f) for i, f in zip(self.drift_ids, flags)}
        return all(by_id.get(i, 1) == 0 for i in want)

    # -- per-cell segmentation mask (reference _load_segmentation,
    #    :2593-2648) -------------------------------------------------------

    def _load_segmentation(self, fov_labels: np.ndarray,
                           extend_dim: int = 20,
                           box: Optional[Box] = None):
        """Keep this cell's ±1 mask and xy bounding crop from the FOV
        label image.

        Behavior target: Cell_Data._load_segmentation
        (classes/__init__.py:2593-2648): mask = +1 inside the cell's
        label, -1 elsewhere, plus the bounding crop used by every later
        per-cell image load.  Difference by design: the label image
        comes from segmentation.segment_nuclei / the store, not the
        retired DAPI watershed re-run.  `box`: this cell's (lo, hi) zxy
        bounding box when the caller already has it (CellList finds all
        of a FOV's in one pass); the mask is then written inside it
        only."""
        if self.cell_id is None:
            raise AttributeError("no cell_id attribute for this cell")
        labels = host_array(fov_labels)
        if box is None:
            try:
                box = _cell_box(labels, self.cell_id)
            except ValueError:
                raise ValueError(f"segmentation label does not contain "
                                 f"cell {self.cell_id}") from None
        seg = np.full(labels.shape, -1, np.int8)
        (z0, x0, y0), (z1, x1, y1) = box
        if labels.ndim == 3:
            inner = (slice(int(z0), int(z1)), slice(int(x0), int(x1)),
                     slice(int(y0), int(y1)))
        else:
            inner = (slice(int(x0), int(x1)), slice(int(y0), int(y1)))
        seg[inner][labels[inner] == int(self.cell_id)] = 1
        self.segmentation_label = seg
        self.segmentation_crop = _xy_crop(box, extend_dim,
                                          labels.shape[-2:])
        return seg, self.segmentation_crop

    # -- save/load (reference _save_to_file/_load_from_file,
    #    :3012-3446) -------------------------------------------------------

    def _save_to_file(self, path: str) -> None:
        """Checkpoint this cell's picking state to one `.npz` (reference
        Cell_Data._save_to_file 'cell_info' mode, classes/__init__.py:
        3012-3190), in the JAX package's layout.  Deliberate difference:
        npz instead of pickle — the store is the pipeline checkpoint; this
        file only carries the notebook-facing picking state."""
        payload: Dict[str, np.ndarray] = {}
        for rid, sp in self.cand_spots.items():
            payload[f"cand_{int(rid)}"] = host_array(sp)
        if self.chrom_coords is not None:
            payload["chrom_coords"] = np.asarray(self.chrom_coords)
        for i, tr in enumerate(getattr(self, "picked_traces", []) or []):
            payload[f"trace_{i}"] = host_array(tr)
        for i, dm in enumerate(getattr(self, "distance_maps", []) or []):
            payload[f"distmap_{i}"] = host_array(dm)
        np.savez_compressed(path, **payload)

    @classmethod
    def _load_from_file(cls, path: str,
                        pixel_size_nm=DEFAULT_PIXEL_SIZE_NM,
                        device=None) -> "CellData":
        """Inverse of :meth:`_save_to_file` (reference _load_from_file,
        classes/__init__.py:3191-3446)."""
        with np.load(path) as fh:
            cand = {int(k[5:]): fh[k] for k in fh.files
                    if k.startswith("cand_")}
            chrom = (list(fh["chrom_coords"])
                     if "chrom_coords" in fh.files else None)
            cell = cls(cand, chrom_coords=chrom,
                       pixel_size_nm=pixel_size_nm, device=device)
            traces = [fh[k] for k in sorted(
                (k for k in fh.files if k.startswith("trace_")),
                key=lambda s: int(s.split("_")[1]))]
            if traces:
                cell.picked_traces = traces
            dmaps = [fh[k] for k in sorted(
                (k for k in fh.files if k.startswith("distmap_")),
                key=lambda s: int(s.split("_")[1]))]
            if dmaps:
                cell.distance_maps = dmaps
        return cell

    # -- picked-spot QC figure (reference _visualize_picked_spots,
    #    :4039-4122) -------------------------------------------------------

    def _visualize_picked_spots(self, im: np.ndarray,
                                chrom_index: int = 0, ax=None):
        """Overlay the picked trace on a projection of `im` (reference
        Cell_Data._visualize_picked_spots, classes/__init__.py:4039-4122,
        which scatter-plots picked spots over the max projection)."""
        from .figures.plots import plot_spot_overlay

        if not hasattr(self, "picked_traces"):
            self._pick_spots()
        trace = self.picked_traces[chrom_index]
        ok = np.isfinite(trace[:, 1])
        spots = np.zeros((int(ok.sum()), 4), np.float32)
        spots[:, 1:4] = trace[ok][:, 1:4]
        return plot_spot_overlay(host_array(im), spots, ax=ax)

    # -- domain calling (reference Cell_Data._domain_calling :4440-4443,
    #    a stub(`pass`); the working implementation is Cell_List.
    #    _batch_domain_calling :2218-2370, whose per-cell core this is) ----

    def _domain_calling(self, method: str = "basic",
                        chrom_index: int = 0, **kwargs) -> np.ndarray:
        """Domain boundary starts for one picked chromosome trace;
        method 'basic' | 'iterative' | 'insulation' | 'sliding-window' |
        'contact-correlation' (analysis.domains, on the cell's device)."""
        from .analysis import domains as D

        if not hasattr(self, "picked_traces"):
            self._pick_spots()
        dev = self._device
        zxys = self._zxys_nm(self.picked_traces[chrom_index])

        def _insulation(z, **kw):
            dm = distance_map(torch.as_tensor(z, dtype=torch.float32,
                                              device=dev))
            return D.insulation_domain_calling(dm, device=dev, **kw)

        fns = {"basic": D.basic_domain_calling,
               "iterative": D.iterative_domain_calling,
               "insulation": _insulation,
               "sliding-window": D.sliding_window_domain_calling,
               "contact-correlation": D.contact_correlation_domain_calling}
        if method not in fns:
            raise ValueError(f"method {method!r} not in {sorted(fns)}")
        if method == "insulation":
            return np.asarray(_insulation(zxys, **kwargs))
        return np.asarray(fns[method](zxys, device=dev, **kwargs))

    # -- RNA -> DNA merge (reference _merge_RNA_to_DNA, :4274-4327) --------

    def _merge_RNA_to_DNA(self, source: "CellData",
                          attr_feature: str = "rna-",
                          overwrite: bool = False) -> List[str]:
        """Append the RNA cell's public data attributes onto this (DNA)
        cell under `attr_feature`-prefixed names.

        Behavior target: Cell_Data._merge_RNA_to_DNA 'cell_info' mode
        (classes/__init__.py:4274-4327): every public attribute of the
        source is copied as `rna-<attr>` (already-prefixed names kept)
        unless present and not overwriting.  Returns the names added.
        """
        added: List[str] = []
        for attr in dir(source):
            if attr.startswith("_") or callable(getattr(source, attr)):
                continue
            new_attr = attr if attr_feature in attr \
                else attr_feature + attr
            if hasattr(self, new_attr.replace("-", "_")) and not overwrite:
                continue
            # python identifiers can't carry '-', the reference stores
            # these in a dict; attributes here use '_'
            setattr(self, new_attr.replace("-", "_"),
                    getattr(source, attr))
            added.append(new_attr)
        return added


def _crop_regions(store: FovStore, data_type: str, boxes: Dict) -> Dict:
    """key -> {region id: (Z, x1-x0, y1-y0) host crop} for every
    (x0, x1, y0, y1) in `boxes`, each stored region image read once.
    Raises KeyError when the data type has no stored images."""
    out: Dict = {k: {} for k in boxes}
    for rid in store.ids(data_type):
        try:
            im = store.load_image(data_type, int(rid))
        except KeyError:
            break
        for k, (x0, x1, y0, y1) in boxes.items():
            out[k][int(rid)] = np.array(im[:, x0:x1, y0:y1])
    if any(not v for v in out.values()):
        raise KeyError(f"no images stored for {data_type}; run the "
                       f"driver with save_images=True")
    return out


class CellList:
    """Experiment-wide driver over cells/FOVs (reference Cell_List,
    classes/__init__.py:817-2370).  `device` (the CUDA card unless
    ``"cpu"``) is the driver's and every cell's."""

    def __init__(self, data_folder: str, save_folder: str,
                 cfg: Optional[ExperimentConfig] = None, device=None,
                 **driver_kwargs):
        self.driver = ExperimentDriver(data_folder, save_folder, cfg=cfg,
                                       device=device, **driver_kwargs)
        self.device = self.driver.device
        self.cells: List[CellData] = []

    def _cell(self, *args, **kwargs) -> CellData:
        return CellData(*args, device=self.device, **kwargs)

    def _store(self, fov: str, mode: str = "r") -> FovStore:
        return FovStore(self.driver.store_path(fov), mode)

    def _process_fovs(self, overwrite: bool = False) -> Dict[str, dict]:
        return self.driver.process_all(overwrite=overwrite)

    def _create_cells(self, data_type: str = "unique") -> List[CellData]:
        """One CellData per FOV from the stored candidate spots (cell
        segmentation gating happens upstream via analysis.partition, or
        per segmented cell via :meth:`_create_cells_fov`)."""
        self.cells = []
        for fov in self.driver.fovs:
            with self._store(fov) as store:
                if data_type not in store.data_types():
                    continue
                spots = store.load_all_spots(data_type)
            self.cells.append(self._cell(spots, fov_name=fov))
        return self.cells

    def _create_cells_fov(self, fov_name: str,
                          data_type: str = "unique",
                          search_radius: int = 10) -> List[CellData]:
        """One CellData per *segmented cell* of one FOV: gate the FOV's
        stored candidate spots through its stored segmentation label
        image.

        Behavior target: Cell_List._create_cells_fov
        (classes/__init__.py:817-966), which segments the FOV's DAPI
        round and builds one Cell_Data per label.  Difference by design:
        segmentation comes from the store (save_segmentation — produced
        by segmentation.segment_nuclei/learned or imported), and the
        spot→cell assignment is the device-side mode-label vote
        (analysis.partition.spots_to_labels) rather than a per-cell
        re-crop of every round."""
        from .analysis.partition import spots_to_labels

        with self._store(fov_name) as store:
            if data_type not in store.data_types():
                raise KeyError(f"no {data_type} spots stored for "
                               f"{fov_name}; run process_fov first")
            labels = store.load_segmentation()
            if labels is None:
                raise KeyError(f"no segmentation stored for {fov_name}; "
                               "save one via store.save_segmentation")
            spots = store.load_all_spots(data_type)
        labels = np.asarray(labels)
        if labels.ndim == 2:                       # pseudo-3D: same every z
            labels = labels[None]
        dev = self.device
        lab_dev = torch.as_tensor(labels.astype(np.int32, copy=False),
                                  device=dev)
        cell_ids = sorted(int(v) for v in host_array(torch.unique(lab_dev))
                          if v > 0)
        by_cell: Dict[int, Dict[int, np.ndarray]] = {
            c: {} for c in cell_ids}
        for rid, sp in spots.items():
            sp = np.asarray(sp)
            if not len(sp):
                continue
            coords = sp[:, 1:4].copy()
            if labels.shape[0] == 1:               # 2D labels: ignore z
                coords[:, 0] = 0.0
            got = host_array(spots_to_labels(
                lab_dev, torch.as_tensor(coords.astype(np.float32),
                                         device=dev),
                torch.ones(len(sp), dtype=torch.bool, device=dev),
                search_radius=search_radius))
            for c in cell_ids:
                by_cell[c][int(rid)] = sp[got == c]
        new = [self._cell(by_cell[c], fov_name=fov_name, cell_id=c)
               for c in cell_ids]
        self.cells.extend(new)
        return new

    # -- batch image/drift loading into cells (reference _load_drift
    #    :2708-2786, _load_segmentation :2593, _load_dapi_image :2649,
    #    _load_chromosome_image :3447, _generate_chromosome_image :3453) ---

    def _load_drift(self, data_type: str = "unique"
                    ) -> Dict[str, np.ndarray]:
        """Attach each cell's persisted per-region drift table
        (`drifts`, `drift_flags`, `drift_ids`) from its FOV store, read
        once per FOV.

        Behavior target: Cell_Data._load_drift (classes/__init__.py:
        2708-2786) prefers the persisted drift file over recomputation;
        recomputation is ExperimentDriver.process_fov's job here (the
        store is the drift file)."""
        out: Dict[str, np.ndarray] = {}
        tables: Dict[str, Optional[tuple]] = {}
        for cell in self.cells:
            if cell.fov_name is None:
                continue
            if cell.fov_name not in tables:
                with self._store(cell.fov_name) as store:
                    tables[cell.fov_name] = (
                        None if data_type not in store.data_types()
                        else (store.ids(data_type), store.drifts(data_type),
                              store.drift_flags(data_type)))
            table = tables[cell.fov_name]
            if table is None:
                continue
            cell.drift_ids, cell.drifts, cell.drift_flags = (
                np.array(a) for a in table)
            out[cell.fov_name] = cell.drifts
        return out

    def _fov_labels(self, fov: str) -> np.ndarray:
        with self._store(fov) as store:
            lab = store.load_segmentation()
        if lab is None:
            raise KeyError(f"no segmentation stored for {fov}")
        return np.asarray(lab)

    def _load_segmentation(self) -> None:
        """Attach each cell's segmentation mask+crop from its FOV store
        (CellData._load_segmentation per cell, every cell's box from one
        pass over its FOV's labels; 1:1-FOV cells get the raw label image
        as `segmentation_label`)."""
        labels_by_fov: Dict[str, np.ndarray] = {}
        boxes_by_fov: Dict[str, Dict[int, Box]] = {}
        for cell in self.cells:
            if cell.fov_name is None:
                continue
            if cell.fov_name not in labels_by_fov:
                labels_by_fov[cell.fov_name] = self._fov_labels(
                    cell.fov_name)
            labels = labels_by_fov[cell.fov_name]
            if cell.cell_id is None:
                cell.segmentation_label = labels
                continue
            if cell.fov_name not in boxes_by_fov:
                boxes_by_fov[cell.fov_name] = _label_boxes(labels,
                                                           self.device)
            box = boxes_by_fov[cell.fov_name].get(int(cell.cell_id))
            if box is None:
                raise ValueError(f"segmentation label does not contain "
                                 f"cell {cell.cell_id}")
            cell._load_segmentation(labels, box=box)

    def _translate_old_segmentations(
            self, old_segmentation_folder: str, old_dapi_folder: str,
            rotation_mat: np.ndarray, save: bool = True,
            save_folder: Optional[str] = None,
            save_postfix: str = "_segmentation",
            upsample_factor: int = 100, force: bool = False,
            new_dapi_by_fov: Optional[Dict[str, np.ndarray]] = None
    ) -> Dict[str, np.ndarray]:
        """Carry segmentation labels over from a previous experiment:
        rotate by the (manually calibrated) 2x2 `rotation_mat`, register
        the rotated old DAPI onto this experiment's DAPI by FFT phase
        correlation, and warp the old labels into the new frame in ONE
        nearest-neighbor resample (reference _translate_old_segmentations
        classes/__init__.py:663-787 -> visual_tools.translate_segmentation;
        rotation+residual-drift semantics segmentation_tools/cell.py:
        548-597), on the list's device.

        Adapted I/O: `old_segmentation_folder` holds `<fov>_segmentation
        .npy` label volumes and `old_dapi_folder` holds the old
        experiment's already-corrected `<fov>.npy` DAPI stacks (the
        reference re-corrects raw `.dax` here; raw correction is
        ExperimentDriver's job in this design).  New-experiment DAPI
        comes from `new_dapi_by_fov` or `driver.load_dapi_image`.  The
        translated labels are saved as `.npy` (unless `save=False`),
        attached to the FOV's cells, and returned per FOV.  Existing
        outputs are reused unless `force` (reference `_force`)."""
        from .analysis.partition import (translate_label_image,
                                         translate_volume)
        from .ops.drift import subpixel_phase_correlation

        dev = self.device
        rot = np.asarray(rotation_mat, np.float32)
        rinv = np.linalg.inv(rot)
        out_dir = save_folder or os.path.join(
            self.driver.save_folder, "Segmentation")
        if save:
            os.makedirs(out_dir, exist_ok=True)
        labels_by_fov: Dict[str, np.ndarray] = {}
        for cell in self.cells:
            fov = cell.fov_name
            if fov is None or fov in labels_by_fov:
                continue
            stem = os.path.splitext(fov)[0]
            new_fl = os.path.join(out_dir, stem + save_postfix + ".npy")
            if not force and os.path.exists(new_fl):
                labels_by_fov[fov] = np.load(new_fl)
                continue
            old_lab = np.load(os.path.join(
                old_segmentation_folder, stem + save_postfix + ".npy"))
            old_dapi = np.load(os.path.join(old_dapi_folder,
                                            stem + ".npy"))
            new_dapi = (new_dapi_by_fov or {}).get(fov)
            if new_dapi is None:
                new_dapi = self.driver.load_dapi_image(fov)
            zero = torch.zeros(3, dtype=torch.float32, device=dev)
            rot_t = torch.as_tensor(rot, device=dev)
            rotated = translate_volume(
                torch.as_tensor(old_dapi, device=dev).to(torch.float32),
                rot_t, zero)
            new_t = as_tensor(new_dapi, dev).to(device=dev,
                                                dtype=torch.float32)
            shift = host_array(subpixel_phase_correlation(
                new_t, rotated, upsample_factor=upsample_factor,
                subtract_mean=True, window="hann_xy"))
            # Fold the post-rotation shift into the single-resample warp:
            # out(o) = rotated(o - d) = src(R^-1(o_xy-c) + c - R^-1 d_xy),
            # so translate_label_image's drift parameter is (d_z, R^-1 d_xy).
            drift = np.array([shift[0], *(rinv @ shift[1:])], np.float32)
            lab = host_array(translate_label_image(
                torch.as_tensor(old_lab, device=dev), rot_t,
                torch.as_tensor(drift, device=dev)))
            if save:
                np.save(new_fl, lab)
            labels_by_fov[fov] = lab
        for cell in self.cells:
            if cell.fov_name not in labels_by_fov:
                continue
            if cell.cell_id is None:
                cell.segmentation_label = labels_by_fov[cell.fov_name]
            else:
                cell._load_segmentation(labels_by_fov[cell.fov_name])
        return labels_by_fov

    def _load_dapi_image(self) -> Dict[str, np.ndarray]:
        """Corrected drift-aligned DAPI stack per FOV, attached to each
        cell as `dapi_im` (ExperimentDriver.load_dapi_image; reference
        _load_dapi_image classes/__init__.py:2649-2686)."""
        ims: Dict[str, np.ndarray] = {}
        for cell in self.cells:
            if cell.fov_name is None:
                continue
            if cell.fov_name not in ims:
                ims[cell.fov_name] = self.driver.load_dapi_image(
                    cell.fov_name)
            cell.dapi_im = ims[cell.fov_name]
        return ims

    def _generate_chromosome_image(self, **kwargs) -> Dict[str, np.ndarray]:
        """Chromosome-paint stack per FOV, attached to each cell as
        `chrom_im` (ExperimentDriver.generate_chromosome_image; reference
        _generate_chromosome_image classes/__init__.py:3453-3550)."""
        ims: Dict[str, np.ndarray] = {}
        for cell in self.cells:
            if cell.fov_name is None:
                continue
            if cell.fov_name not in ims:
                ims[cell.fov_name] = self.driver.generate_chromosome_image(
                    cell.fov_name, **kwargs)
            cell.chrom_im = ims[cell.fov_name]
        return ims

    def _load_chromosome_image(self) -> Dict[str, np.ndarray]:
        """Cached-only variant of :meth:`_generate_chromosome_image`
        (reference _load_chromosome_image, classes/__init__.py:3447-3452,
        which reads the saved chrom_im)."""
        return self._generate_chromosome_image(save=False,
                                               overwrite=False)

    # -- batch fitting + cropping (reference _spot_finding_for_cells
    #    :1494-1532, _crop_image_for_cells :967-1018) ----------------------

    def _cells_by_fov(self, keep) -> Dict[str, List[Tuple[int, CellData]]]:
        by_fov: Dict[str, List[Tuple[int, CellData]]] = {}
        for idx, cell in enumerate(self.cells):
            if cell.fov_name is not None and keep(cell):
                by_fov.setdefault(cell.fov_name, []).append((idx, cell))
        return by_fov

    def _spot_finding_for_cells(self, data_type: str = "unique",
                                **fit_kwargs) -> None:
        """Multi-fit every cell's chromosome neighborhoods from its
        stored region images (CellData._multi_fitting_for_chromosome per
        cell; reference _spot_finding_for_cells classes/__init__.py:
        1494-1532 loops _multi_fitting_for_chromosome the same way).
        Each region image is read and sent to the device once per FOV,
        then every cell of the FOV is fitted on it; a cell's candidates
        equal those of its own ``_multi_fitting_for_chromosome`` call.
        Requires the driver to have run with save_images=True and
        chrom_coords attached (_get_chromosomes_for_cells)."""
        for fov, cells in self._cells_by_fov(
                lambda c: bool(c.chrom_coords)).items():
            with self._store(fov) as store:
                if data_type not in store.data_types():
                    continue
                found: Dict[int, Dict[int, np.ndarray]] = {
                    idx: {} for idx, _ in cells}
                for rid in store.ids(data_type):
                    try:
                        im = store.load_image(data_type, int(rid))
                    except KeyError:
                        raise KeyError(
                            f"no images stored for {data_type}; run the "
                            "driver with save_images=True") from None
                    im = torch.as_tensor(np.asarray(im),
                                         device=self.device).to(
                                             torch.float32)
                    for idx, cell in cells:
                        found[idx].update(cell._multi_fitting_for_chromosome(
                            {int(rid): im}, **fit_kwargs))
                    del im
            for idx, cell in cells:
                cell.cand_spots = found[idx]

    def _crop_image_for_cells(self, data_type: str = "unique",
                              extend_dim: int = 20
                              ) -> Dict[int, Dict[int, np.ndarray]]:
        """Per-cell region-image crops for every segmented cell
        (CellData._crop_images per cell; reference _crop_image_for_cells
        classes/__init__.py:967-1018 / _crop_image_by_fov :1019-1116,
        which group the crop work by FOV so each round is read once —
        here each stored image is read once per FOV and every cell's box
        sliced from it)."""
        out: Dict[int, Dict[int, np.ndarray]] = {}
        for fov, cells in self._cells_by_fov(
                lambda c: c.cell_id is not None).items():
            labels = self._fov_labels(fov)
            boxes = _label_boxes(labels, self.device)
            crops = {}
            for idx, cell in cells:
                box = boxes.get(int(cell.cell_id))
                if box is None:
                    raise ValueError(f"cell {cell.cell_id} absent from "
                                     f"segmentation")
                (x0, x1), (y0, y1) = _xy_crop(box, extend_dim)
                crops[idx] = (x0, x1, y0, y1)
            with self._store(fov) as store:
                out.update(_crop_regions(store, data_type, crops))
        return dict(sorted(out.items()))

    def _update_chromosomes_for_cells(
            self, coords_by_cell: Sequence[Sequence[np.ndarray]],
            save: bool = False,
            folder: Optional[str] = None) -> None:
        """Distribute externally picked chromosome coordinates (e.g.
        figures.interactive manual picks) to cells, padding missing
        entries with empty lists.

        Behavior target: Cell_List._update_chromosomes_for_cells
        (classes/__init__.py:1373-1447), which partitions a saved
        manual-pick file across cells and appends empties when fewer
        pick sets than cells exist.  Coordinates are zxy already (the
        reference flips its xyz GUI picks)."""
        if len(coords_by_cell) > len(self.cells):
            raise ValueError(
                f"{len(coords_by_cell)} pick sets for "
                f"{len(self.cells)} cells")
        coords = list(coords_by_cell)
        coords += [[] for _ in range(len(self.cells) - len(coords))]
        for i, (cell, picks) in enumerate(zip(self.cells, coords)):
            cell.chrom_coords = [np.asarray(c, float) for c in picks]
            if save:
                fold = folder or self.driver.save_folder
                os.makedirs(fold, exist_ok=True)
                cell._save_to_file(os.path.join(fold, f"cell_{i}.npz"))

    # -- experiment metadata (reference _load_color_info etc.,
    #    classes/__init__.py:337-406) --------------------------------------

    def _load_color_info(self, color_filename: str = "Color_Usage"):
        from .io.color_usage import load_color_usage
        self.color_usage = load_color_usage(self.driver.data_folder,
                                            filename=color_filename)
        return self.color_usage

    def _load_encoding_scheme(self,
                              encoding_filename: str = "Encoding_Scheme"):
        from .io.color_usage import load_encoding_scheme
        self.encoding_scheme = load_encoding_scheme(
            self.driver.data_folder, encoding_filename=encoding_filename)
        return self.encoding_scheme

    def _load_genomic_regions(self, filename: str = "Region_Positions"):
        from .io.color_usage import load_region_positions
        self.region_positions = load_region_positions(
            self.driver.save_folder, filename=filename)
        return self.region_positions

    def _load_rna_info(self, filename: str = "RNA_Info"):
        from .io.color_usage import load_rna_info
        self.rna_info = load_rna_info(self.driver.save_folder,
                                      filename=filename)
        return self.rna_info

    def _load_gene_info(self, filename: str = "Gene_Info"):
        from .io.color_usage import load_gene_info
        self.gene_info = load_gene_info(self.driver.save_folder,
                                        filename=filename)
        return self.gene_info

    # -- batch chromosome/pick drivers (reference
    #    _get_chromosomes_for_cells :1299-1372,
    #    _pick_spots_for_cells :1533-1627) ---------------------------------

    def _get_chromosomes_for_cells(self, expected_per_nucleus: int = 2,
                                   **kwargs) -> List[np.ndarray]:
        """Identify chromosome centers per FOV and attach them to the
        FOV's CellData (reference _get_chromosomes_for_cells,
        classes/__init__.py:1299-1372, which seeds the chromosome image
        per cell).  Requires `_create_cells` first; cells map 1:1 to
        FOVs here (segmentation gating happens upstream)."""
        if not self.cells:
            self._create_cells()
        out = []
        for fov, cell in zip(self.driver.fovs, self.cells):
            coords, _, _ = self.driver.identify_chromosomes(
                fov, expected_per_nucleus=expected_per_nucleus, **kwargs)
            cell.chrom_coords = [np.asarray(c) for c in coords]
            out.append(np.asarray(coords))
        return out

    def _pick_spots_for_cells(self, method: str = "EM",
                              **kwargs) -> List[List[np.ndarray]]:
        """Pick traces for every cell (reference _pick_spots_for_cells,
        classes/__init__.py:1533-1627)."""
        return [cell._pick_spots(method=method, **kwargs)
                for cell in self.cells]

    def _translate_chromosome_coords(
            self, source_cell_list: "CellList",
            rotation_mat: np.ndarray, rotation_order: str = "reverse",
            border_lim: int = 10, overwrite: bool = True
    ) -> List[Optional[List[np.ndarray]]]:
        """Carry chromosome centers over from another experiment's
        CellList: match each cell by (fov_name, cell_id), pick a
        border-aware per-cell rotation center in each experiment, and map
        src zxy -> [z - src_cz + tar_cz, R @ (xy - src_cxy) + tar_cxy]
        (reference _translate_chromosome_coords classes/__init__.py:
        1422-1491 -> visual_tools.translate_chromosome_coordinates:
        2857-2960; `rotation_order='reverse'` transposes the matrix the
        same way).  Cells without a unique source match are skipped
        (returned as None), matching the reference's skip branch.

        Reference semantics where the JAX package differs: the FOV's
        extent is the driver's ``cfg.image_size``; with no cfg it is
        unbounded (no crop touches the high border, so interior cells
        keep their crop midpoints) rather than guessed from the crops;
        and ``overwrite`` defaults to True (the reference's
        ``force=True``), so a target cell's existing coordinates are
        replaced."""
        rot = np.asarray(rotation_mat, np.float64)
        if rot.shape != (2, 2):
            raise ValueError(f"rotation_mat must be 2x2, got {rot.shape}")
        if rotation_order not in ("forward", "reverse"):
            raise ValueError(f"bad rotation_order: {rotation_order}")
        if rotation_order == "reverse":
            rot = rot.T
        image_size = self.driver.cfg.image_size \
            if getattr(self.driver, "cfg", None) is not None else None
        out: List[Optional[List[np.ndarray]]] = []
        for cell in self.cells:
            matches = [s for s in source_cell_list.cells
                       if s.fov_name == cell.fov_name
                       and s.cell_id == cell.cell_id]
            if (len(matches) != 1
                    or getattr(matches[0], "chrom_coords", None) is None):
                out.append(None)
                continue
            src = matches[0]
            src_c = [self._fov_z_center(src, image_size)]
            tar_c = [self._fov_z_center(cell, image_size)]
            for ax in range(2):
                s_lo, s_hi = (int(v) for v in src.segmentation_crop[ax])
                t_lo, t_hi = (int(v) for v in cell.segmentation_crop[ax])
                fov_lim = (image_size[ax + 1] if image_size is not None
                           else np.inf)
                s_ct, t_ct = _border_aware_centers(
                    s_lo, s_hi, t_lo, t_hi, fov_lim, border_lim)
                src_c.append(s_ct)
                tar_c.append(t_ct)
            src_c = np.asarray(src_c)
            tar_c = np.asarray(tar_c)
            coords = []
            for c in src.chrom_coords:
                rel = np.asarray(c, np.float64) - src_c
                coords.append(np.array(
                    [rel[0], *(rot @ rel[1:])]) + tar_c)
            if overwrite or getattr(cell, "chrom_coords", None) is None:
                cell.chrom_coords = coords
            out.append(coords)
        return out

    def _transfer_data_type(self, data_type: str = "unique",
                            target_type: str = "rna-unique",
                            overwrite: bool = False) -> List[str]:
        """Clone every FOV store's `data_type` group to `target_type`
        (reference Cell_Data._transfer_data_type classes/__init__.py:
        4329-4443: copies *_ims/*_ids/*_channels/*_spots attributes to a
        new data-type name; here the store group IS that attribute set).
        Returns the FOV names transferred."""
        done: List[str] = []
        seen = set()
        for cell in self.cells:
            fov = cell.fov_name
            if fov is None or fov in seen:
                continue
            seen.add(fov)
            with self._store(fov, "a") as store:
                if data_type not in store.data_types():
                    continue
                store.transfer_data_type(data_type, target_type,
                                         overwrite=overwrite)
            done.append(fov)
        return done

    @staticmethod
    def _fov_z_center(cell: CellData,
                      image_size: Optional[Sequence[int]]) -> float:
        """z rotation center: cells span the full z extent here (the
        segmentation crop is xy-only by design), so the center is the
        stack midplane — the analog of the reference's mean of the z
        crop window (visual_tools.py:2913)."""
        if image_size is not None:
            return (image_size[0] - 1) / 2.0
        return 0.0

    # -- intensity statistics + p-value screen (reference
    #    _get_intensity_stats :1886-2001, _p_value_filter :2002-2094) ------

    def _get_intensity_stats(self) -> Dict[int, Dict[str, float]]:
        """Pool candidate-spot intensities per region id across all cells
        and fit a per-region Gaussian (reference _get_intensity_stats,
        classes/__init__.py:1886-2001, which gaussian-fits the pooled
        per-region intensities for the p-value filter).  Returns
        {region_id: {'median', 'mean', 'std', 'params': (mu, sigma)}}."""
        pooled: Dict[int, List[np.ndarray]] = {}
        for cell in self.cells:
            for rid, sp in cell.cand_spots.items():
                sp = host_array(sp)
                if len(sp):
                    pooled.setdefault(int(rid), []).append(sp[:, 0])
        stats = {}
        for rid, chunks in pooled.items():
            v = np.concatenate(chunks)
            if not len(v):
                continue
            mu, sigma = float(np.mean(v)), float(np.std(v) + 1e-12)
            stats[rid] = {"median": float(np.median(v)),
                          "mean": mu, "std": sigma,
                          "params": (mu, sigma)}
        self.intensity_stats = stats
        return stats

    def _p_value_filter(self, pval_th=(1e-6, 0.01),
                        ref_dist_params: Optional[Dict] = None
                        ) -> List[Dict[int, np.ndarray]]:
        """Ternary intensity flags per candidate spot under the
        per-region Gaussian reference distribution (reference
        _p_value_filter, classes/__init__.py:2002-2094): one-sided
        survival p = sf((intensity - mu) / sigma); flag +1 when
        p < min(pval_th) (significantly brighter than the reference
        distribution), -1 when p >= max(pval_th) (not significant),
        else 0.  Returns per-cell {region_id: int8 flags}, also stored
        as `cell.pval_flags`."""
        from math import erf, sqrt

        params = ref_dist_params or getattr(self, "intensity_stats",
                                            None) or \
            self._get_intensity_stats()
        lo, hi = float(min(pval_th)), float(max(pval_th))
        out = []
        for cell in self.cells:
            flags: Dict[int, np.ndarray] = {}
            for rid, sp in cell.cand_spots.items():
                sp = host_array(sp)
                st = params.get(int(rid))
                if st is None or not len(sp):
                    flags[int(rid)] = np.zeros(len(sp), np.int8)
                    continue
                mu, sigma = st["params"]
                z = (sp[:, 0] - mu) / sigma
                # one-sided survival function of N(0, 1)
                pv = np.array([0.5 * (1.0 - erf(x / sqrt(2.0)))
                               for x in z])
                f = np.zeros(len(sp), np.int8)
                f[pv < lo] = 1
                f[pv >= hi] = -1
                flags[int(rid)] = f
            cell.pval_flags = flags
            out.append(flags)
        return out

    # -- batch domain calling (reference _batch_domain_calling,
    #    :2218-2370) -------------------------------------------------------

    def _batch_domain_calling(self, method: str = "iterative",
                              **kwargs) -> List[List[np.ndarray]]:
        """Domain starts for every picked chromosome of every cell
        (reference _batch_domain_calling, classes/__init__.py:2218-2370;
        per-trace core = CellData._domain_calling)."""
        out = []
        for cell in self.cells:
            if not hasattr(cell, "picked_traces"):
                cell._pick_spots()
            out.append([cell._domain_calling(method=method, chrom_index=i,
                                             **kwargs)
                        for i in range(len(cell.picked_traces))])
        return out

    # -- cell checkpointing (reference _save_cells_to_files :1263-1298,
    #    _load_cells_from_files :1221-1262) --------------------------------

    def _save_cells_to_files(self, folder: Optional[str] = None) -> List[str]:
        folder = folder or self.driver.save_folder
        os.makedirs(folder, exist_ok=True)
        paths = []
        for i, cell in enumerate(self.cells):
            p = os.path.join(folder, f"cell_{i}.npz")
            cell._save_to_file(p)
            paths.append(p)
        return paths

    def _load_cells_from_files(self, folder: Optional[str] = None
                               ) -> List[CellData]:
        import glob
        folder = folder or self.driver.save_folder
        paths = sorted(glob.glob(os.path.join(folder, "cell_*.npz")),
                       key=lambda p: int(
                           os.path.basename(p)[5:-4]))
        self.cells = [CellData._load_from_file(p, device=self.device)
                      for p in paths]
        return self.cells

    def _calculate_population_map(self, stat_type: str = "median",
                                  contact_th: float = 200.0,
                                  max_loss_prob: float = 0.2,
                                  return_all_maps: bool = False):
        """Population map across all cells (reference
        Cell_List._calculate_population_map, classes/__init__.py:
        1628-1805): collect per-cell distance maps, drop chromosomes
        whose all-NaN-row fraction exceeds `max_loss_prob` or whose
        shape disagrees with the majority, then reduce (float64 on the
        host, as in the JAX package).

        stat_type: 'median' | 'mean' (nan-aware) | 'contact'
        (fraction of cells with distance < `contact_th` nm, the
        reference's `< _contact_th` over `< + >` normalization).
        Returns (map, n_chromosomes_used) — or
        (map, n, all_maps) with return_all_maps.
        """
        maps = []
        for cell in self.cells:
            if not hasattr(cell, "distance_maps"):
                cell._generate_distance_map()
            maps.extend(cell.distance_maps)
        out, n, total = self._screen_and_reduce(maps, stat_type,
                                                contact_th, max_loss_prob)
        if return_all_maps:
            return out, n, total
        return out, n

    @staticmethod
    def _screen_and_reduce(maps: Sequence[np.ndarray], stat_type: str,
                           contact_th: float, max_loss_prob: float):
        """Loss screen + majority-shape screen + nan-aware reduction
        shared by the population-map variants (reference
        _calculate_population_map classes/__init__.py:1628-1805)."""
        if stat_type not in ("median", "mean", "contact"):
            raise ValueError(f"stat_type {stat_type!r} not in "
                             f"median/mean/contact")
        cand: List[np.ndarray] = []
        for dmap in maps:
            dmap = host_array(dmap)
            n = len(dmap)
            failure = np.sum(np.isnan(dmap).sum(0) >= n - 1) / n
            if failure > max_loss_prob:
                continue
            cand.append(np.asarray(dmap, np.float64))
        if not cand:
            raise ValueError("no distance maps survive the loss screen")
        sizes = [m.shape[0] for m in cand]
        keep_n = max(set(sizes), key=sizes.count)
        cand = [m for m in cand if m.shape[0] == keep_n]
        total = np.stack(cand)
        with np.errstate(all="ignore"):
            if stat_type == "median":
                out = np.nanmedian(total, axis=0)
            elif stat_type == "mean":
                out = np.nanmean(total, axis=0)
            else:
                close = np.nansum(total < contact_th, axis=0)
                far = np.nansum(total > contact_th, axis=0)
                out = close / np.maximum(close + far, 1)
        return out, len(cand), total

    def _generate_dependent_maps(self, flags: Sequence[Sequence],
                                 gene_id: Optional[int] = None,
                                 stat_type: str = "median",
                                 contact_th: float = 200.0,
                                 max_loss_prob: float = 0.2):
        """Split each cell's per-chromosome distance maps by a ternary
        flag (e.g. the RNA-expression flags `_merge_RNA_to_DNA` yields)
        and reduce the two pools into flag-dependent population maps
        (reference _generate_dependent_maps classes/__init__.py:
        2095-2217: filters _flags into on/off groups, then runs the
        population-map statistics per group; plotting is figures.plots'
        job here).  `flags[i][j]` gates cell i's chromosome j through
        ``f = np.max(flag)``, as the reference (:2136-2161): ``f > 0`` ->
        'on', ``f < 0`` -> 'off', ``f == 0`` -> neither pool; a dict flag
        is resolved through `gene_id` first (the reference's
        combined-gene flag form).  The JAX package splits by truthiness
        instead.  Returns {'on': (map, n) | None, 'off': (map, n) |
        None}."""
        if len(flags) != len(self.cells):
            raise ValueError("flags must have exactly one entry per cell")
        on_maps, off_maps = [], []
        for cell, cell_flags in zip(self.cells, flags):
            if not hasattr(cell, "distance_maps"):
                cell._generate_distance_map()
            if len(cell_flags) != len(cell.distance_maps):
                raise ValueError("one flag per chromosome is required")
            for dmap, flg in zip(cell.distance_maps, cell_flags):
                if isinstance(flg, dict):
                    if gene_id is None or gene_id not in flg:
                        raise ValueError("combined-gene flags require a "
                                         "gene_id present in every flag")
                    flg = flg[gene_id]
                f = np.max(np.asarray(host_array(flg)))
                if f > 0:
                    on_maps.append(dmap)
                elif f < 0:
                    off_maps.append(dmap)
        out = {}
        for key, pool in (("on", on_maps), ("off", off_maps)):
            if pool:
                m, n, _ = self._screen_and_reduce(pool, stat_type,
                                                  contact_th,
                                                  max_loss_prob)
                out[key] = (m, n)
            else:
                out[key] = None
        return out
