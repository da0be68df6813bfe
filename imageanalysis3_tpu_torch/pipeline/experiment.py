"""Experiment-level driver: hyb folders of .dax files -> per-FOV spot store.

The counterpart of ``imageanalysis3_tpu/pipeline/experiment.py``.
Behavior targets (reference ImageAnalysis3):
  * per-(dax, channels) worker       classes/batch_functions.py:60-302
    (batch_process_image_to_spots: skip-if-done, correct, drift, fit, save)
  * experiment orchestration         classes/field_of_view.py:901-1158
    (_process_image_to_spots: folder scan, ref round, task fan-out)
  * data-type accounting             classes/batch_functions.py:36-57
    (_color_dic_stat: 'u101' -> unique id 101 on channel '750')
  * resumability                     classes/field_of_view.py:1453-1522
    (reprocess only regions whose store flag is below the requested level)

A single controller streams rounds through one :class:`FovPipeline` per
channel layout on the driver's device (the CUDA card unless
``device="cpu"``) and owns the store outright, so resume is a read of the
`flags` dataset and there are no locks.  A loader thread reads the next
round's .dax while the device works on the current one; it makes no CUDA
call and hands NumPy blocks to the main thread, which uploads them.  The
store is h5py's HDF5 file or, where h5py is missing, the NumPy directory
format (``io.store``); the driver talks to it through public methods only.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import CHANNEL_SEED_THRESHOLDS, ExperimentConfig
from ..device import resolve_device
from ..io.color_usage import ColorUsage, find_hyb_folders, load_color_usage
from ..io.dax import (_normalize_crop_limits, raw_frame_window,
                      read_channel_crops, read_raw_window, resample_window)
from ..io.native_loader import load_dax_channels
from ..io.profiles_io import load_correction_profile
from ..io.store import (FLAG_CORRECTED, FLAG_EMPTY, AsyncFovWriter, FovStore,
                        store_backend as resolve_store_backend)
from ..ops.corrections import deinterleave_stack
from ..ops.warp import warp_image_drift
from ..segmentation.chromosome import (find_candidate_chromosomes,
                                       select_candidate_chromosomes)
from ..tracing import StageTimes
from .fov import FovPipeline

#: data_type <-> region-id prefix (reference classes/__init__.py:22-32)
DATA_TYPE_PREFIXES = {
    "combo": "c",
    "decoded": "d",
    "unique": "u",
    "relabeled_combo": "l",
    "relabeled_unique": "v",
    "merfish": "m",
    "rna": "r",
    "gene": "g",
    "protein": "p",
}
_PREFIX_TO_TYPE = {v: k for k, v in DATA_TYPE_PREFIXES.items()}

#: store file (h5py) or directory (NumPy) suffix per backend
_STORE_SUFFIX = {"h5py": ".hdf5", "npy": ".fovstore"}


def parse_region_entry(info: str) -> Optional[Tuple[str, int]]:
    """'u101' -> ('unique', 101); beads/DAPI/empty/chrom -> None
    (reference _color_dic_stat, classes/batch_functions.py:36-57)."""
    if not info or "chrom" in info:
        return None
    prefix = info[0].lower()
    if prefix not in _PREFIX_TO_TYPE:
        return None
    try:
        return _PREFIX_TO_TYPE[prefix], int(info[1:])
    except ValueError:
        return None


@dataclass
class RoundPlan:
    """One hybridization round of one FOV: what to read, fit, and save."""

    folder: str                          # hyb folder path
    channels: List[str]                  # channels to de-interleave, in order
    fit_channel_indices: List[int]       # indices into `channels` to fit
    regions: List[Tuple[str, int]]       # (data_type, region_id) per fit channel
    drift_channel_index: int             # index into `channels` (beads)


@dataclass
class RawRound:
    """One round's raw interleaved frame window (device-deinterleave
    input mode): `block` is the (F, H, W) uint16 read, `window` the
    layout (io.dax.RawFrameWindow) the device slices channels out with."""

    block: np.ndarray
    window: object


class ExperimentDriver:
    """Scan an experiment folder and drive every FOV through the pipeline.

    Parameters
    ----------
    data_folder : experiment root holding H*-prefixed hyb folders
    save_folder : where the per-FOV stores are written
    cfg : ExperimentConfig (image size per channel, correction/drift/seed/fit)
    color_usage : parsed table; loaded from `data_folder` when omitted
    ref_folder : hyb folder used as drift reference (default: first)
    store_backend : None (h5py when it imports, else NumPy files), "h5py"
        or "npy"; see ``io.store``
    device : torch device of every pipeline; None means the CUDA card
    """

    def __init__(self, data_folder: str, save_folder: str,
                 cfg: Optional[ExperimentConfig] = None,
                 color_usage: Optional[ColorUsage] = None,
                 ref_folder: Optional[str] = None,
                 illumination_profiles: Optional[Dict[str, np.ndarray]] = None,
                 bleed_profile: Optional[np.ndarray] = None,
                 chromatic_constants: Optional[Dict[str, np.ndarray]] = None,
                 spot_capacity: Optional[int] = None,
                 bead_name: str = "beads",
                 save_images: bool = False,
                 sequential_drift: bool = False,
                 correction_folder: Optional[str] = None,
                 async_writes: bool = True,
                 device_deinterleave: bool = False,
                 store_backend: Optional[str] = None,
                 device=None):
        self.device = resolve_device(device)
        self.data_folder = data_folder
        self.save_folder = save_folder
        os.makedirs(save_folder, exist_ok=True)
        self.cfg = cfg or ExperimentConfig()
        self.color_usage = color_usage or load_color_usage(data_folder)
        self.folders, self.fovs = find_hyb_folders(data_folder)
        if not self.folders:
            raise FileNotFoundError(f"no hyb folders under {data_folder}")
        self.ref_folder = ref_folder or self.folders[0]
        self.bead_name = bead_name
        self.illumination_profiles = illumination_profiles or {}
        self.bleed_profile = bleed_profile
        self.chromatic_constants = chromatic_constants or {}
        if correction_folder:
            self._load_correction_folder(correction_folder)
        self.spot_capacity = spot_capacity or self.cfg.seed.max_num_seeds
        #: also persist corrected image stacks (reference `ims` datasets,
        #: classes/batch_functions.py:305-368); off by default — spots and
        #: drifts are the scientific output, images are QC payload
        self.save_images = bool(save_images)
        #: register each round against the *previous* round and accumulate
        #: (reference Calculate_Bead_Drift sequential mode,
        #: corrections.py:21-278) instead of against one reference round.
        #: Robust when drift grows beyond a crop between first and last hyb.
        self.sequential_drift = bool(sequential_drift)
        #: hand checkpoint writes to a background thread (AsyncFovWriter)
        #: so the dispatch loop never blocks on storage
        self.async_writes = bool(async_writes)
        #: raw-read input mode: the host reads each round's contiguous
        #: interleaved frame window with one sequential read and the
        #: channel de-interleave runs on the device
        #: (io.dax.raw_frame_window + ops.corrections.deinterleave_stack)
        self.device_deinterleave = bool(device_deinterleave)
        #: the store's file format ("h5py" or "npy"), fixed for the driver
        self.store_backend = resolve_store_backend(store_backend)
        self._pipelines: Dict[Tuple, FovPipeline] = {}
        self.timings = StageTimes()
        self._plans = self._build_plans()

    def _load_correction_folder(self, folder: str) -> None:
        """Populate profiles from a reference-convention correction folder
        (reference Field_of_View._load_correction_profiles,
        classes/field_of_view.py:415; file naming io_tools/load.py:553-640).
        Missing files are skipped — explicit kwargs take precedence.
        """
        chs = list(self.cfg.corr_channels)
        size = tuple(self.cfg.image_size)
        ref_ch = self.cfg.chromatic_ref_channel
        if not self.illumination_profiles:
            try:
                self.illumination_profiles = load_correction_profile(
                    "illumination", folder, chs, ref_ch, size)
            except FileNotFoundError:
                pass
        if self.bleed_profile is None:
            try:
                self.bleed_profile = load_correction_profile(
                    "bleedthrough", folder, chs, ref_ch, size)
            except FileNotFoundError:
                pass
        if not self.chromatic_constants:
            try:
                consts = load_correction_profile(
                    "chromatic_constants", folder, chs, ref_ch, size)
                self.chromatic_constants = {
                    ch: v for ch, v in consts.items() if v is not None}
            except FileNotFoundError:
                pass

    # -- planning ---------------------------------------------------------

    def _folder_key(self, folder: str) -> str:
        return os.path.basename(folder)

    def _bead_channel(self) -> str:
        cu = self.color_usage
        bead_idx = cu.bead_channel_index(self.bead_name)
        if bead_idx is None:
            raise ValueError("Color_Usage has no bead channel; drift needs one")
        return cu.channels[bead_idx]

    def _build_plans(self) -> List[RoundPlan]:
        cu = self.color_usage
        bead_ch = self._bead_channel()
        plans = []
        for folder in self.folders:
            key = self._folder_key(folder)
            if key not in cu.usage:
                continue
            fit_chs, regions = [], []
            for ch, info in zip(cu.channels, cu.usage[key]):
                parsed = parse_region_entry(info)
                if parsed is not None:
                    fit_chs.append(ch)
                    regions.append(parsed)
            if not fit_chs:
                continue
            channels = fit_chs + ([bead_ch] if bead_ch not in fit_chs else [])
            plans.append(RoundPlan(
                folder=folder, channels=channels,
                fit_channel_indices=[channels.index(c) for c in fit_chs],
                regions=regions,
                drift_channel_index=channels.index(bead_ch)))
        return plans

    def _bead_only_plan(self) -> RoundPlan:
        """Drift-only plan for a ref_folder that carries no fit channels
        (the reference supports beads-only reference rounds,
        classes/field_of_view.py:734-801)."""
        return RoundPlan(folder=self.ref_folder,
                         channels=[self._bead_channel()],
                         fit_channel_indices=[], regions=[],
                         drift_channel_index=0)

    def region_table(self) -> Dict[str, List[Tuple[int, str]]]:
        """data_type -> (region id, channel) pairs sorted by id
        (reference _color_dic_stat's sorted ids/channels)."""
        table: Dict[str, List[Tuple[int, str]]] = {}
        for plan in self._plans:
            for (dtype, rid), ci in zip(plan.regions,
                                        plan.fit_channel_indices):
                table.setdefault(dtype, []).append((rid, plan.channels[ci]))
        return {k: sorted(v) for k, v in table.items()}

    # -- pipeline cache ---------------------------------------------------

    def _pipeline_for(self, plan: RoundPlan) -> FovPipeline:
        key = (tuple(plan.channels), tuple(plan.fit_channel_indices),
               plan.drift_channel_index)
        if key in self._pipelines:
            return self._pipelines[key]
        n_ch = len(plan.channels)
        shape = self.cfg.image_size
        illum = None
        if self.illumination_profiles:
            illum = np.stack([
                self.illumination_profiles.get(
                    ch, np.ones(shape[1:], np.float32))
                for ch in plan.channels]).astype(np.float32)
        chrom = None
        if self.chromatic_constants:
            n_mono = next(iter(self.chromatic_constants.values())).shape[-1]
            chrom = np.zeros((n_ch, 3, n_mono), np.float32)
            for i, ch in enumerate(plan.channels):
                if ch in self.chromatic_constants:
                    chrom[i] = self.chromatic_constants[ch]
        th = np.array([CHANNEL_SEED_THRESHOLDS.get(ch, self.cfg.seed.th_seed)
                       for ch in plan.channels], np.float32)
        # subset/expand the (corr x corr) bleed profile to this round's
        # channel layout, identity for non-correction channels (reference
        # per-round profile subsetting, classes/field_of_view.py:1079-1092)
        bleed = None
        if self.bleed_profile is not None:
            corr = [str(c) for c in self.cfg.corr_channels]
            src = np.asarray(self.bleed_profile, np.float32)
            bleed = np.zeros((n_ch, n_ch) + tuple(shape[1:]), np.float32)
            for i, chi in enumerate(plan.channels):
                for j, chj in enumerate(plan.channels):
                    if chi in corr and chj in corr:
                        bleed[i, j] = src[corr.index(chi), corr.index(chj)]
                    elif i == j:
                        bleed[i, i] = 1.0
        pipe = FovPipeline(
            self.cfg, n_channels=n_ch,
            drift_channel_index=plan.drift_channel_index,
            fit_channel_indices=tuple(plan.fit_channel_indices),
            illumination=illum, bleed=bleed,
            chromatic_constants=chrom, image_shape=shape,
            seed_thresholds=th, device=self.device)
        self._pipelines[key] = pipe
        return pipe

    # -- per-FOV processing ----------------------------------------------

    def store_path(self, fov_name: str) -> str:
        """`<fov>.hdf5` (h5py) or the `<fov>.fovstore` directory (NumPy)."""
        base = os.path.splitext(fov_name)[0]
        return os.path.join(self.save_folder,
                            base + _STORE_SUFFIX[self.store_backend])

    def _store(self, fov_name: str, mode: str = "a") -> FovStore:
        return FovStore(self.store_path(fov_name), mode,
                        backend=self.store_backend)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _load_round(self, plan: RoundPlan, fov_name: str):
        """Read one round's .dax into host memory (no CUDA call: the
        loader thread runs this).

        Default: the native fused loader (io/native/daxload.cpp: parallel
        pread of each frame straight into its channel slot, one pass)
        -> (C, Z, X, Y) uint16, with the NumPy path where it did not build.

        With ``device_deinterleave``: one sequential read of the raw
        interleaved frame window -> :class:`RawRound`, de-interleaved on
        the device."""
        path = os.path.join(plan.folder, fov_name)
        layout = dict(n_z=self.cfg.image_size[0],
                      buffer_frames=self.cfg.num_buffer_frames,
                      empty_frames=self.cfg.num_empty_frames)
        with self.timings.stage("load_dax",
                                folder=self._folder_key(plan.folder)):
            if self.device_deinterleave:
                window = raw_frame_window(plan.channels,
                                          self.color_usage.channels, **layout)
                return RawRound(block=read_raw_window(path, window),
                                window=window)
            return load_dax_channels(path, plan.channels,
                                     self.color_usage.channels, **layout)

    def _to_stack(self, ims) -> torch.Tensor:
        """A host round on the device as (C, Z, X, Y): a RawRound through
        the on-device de-interleave, a channel stack as it is (for
        consumers that need the full stack: the reference correction,
        save_images, sequential mode)."""
        if isinstance(ims, RawRound):
            w = ims.window
            return deinterleave_stack(
                torch.as_tensor(ims.block, device=self.device),
                w.rel_starts, w.n_colors, w.n_z)
        return torch.as_tensor(ims, device=self.device)

    @staticmethod
    def _dispatch_round(pipe: FovPipeline, ims, ref_im):
        """One round on the device, for either input mode."""
        if isinstance(ims, RawRound):
            w = ims.window
            return pipe.process_round_raw(ims.block, ref_im,
                                          w.rel_starts, w.n_colors)
        return pipe.process_round(ims, ref_im)

    def _reference_image(self, fov_name: str) -> torch.Tensor:
        """Per-crop drift spectra of the reference round's corrected
        drift-channel stack, computed once per FOV.

        A ref_folder with no fit channels (e.g. a beads-only reference
        round) still serves as the drift reference via a bead-only plan —
        never silently substituted by another round."""
        ref_plans = [p for p in self._plans if p.folder == self.ref_folder]
        plan = ref_plans[0] if ref_plans else self._bead_only_plan()
        pipe = self._pipeline_for(plan)
        ims = self._to_stack(self._load_round(plan, fov_name))
        with self.timings.stage("correct_reference"):
            ref_spec = pipe.prepare_reference(pipe.correct_reference(ims))
            self._sync()
        return ref_spec

    def process_fov(self, fov_name: str,
                    overwrite: bool = False) -> Dict[str, int]:
        """Run every pending hyb round of one FOV; returns per-data_type
        counts of regions processed this call (0 everywhere = resume no-op).
        """
        table = self.region_table()
        processed = {k: 0 for k in table}
        t0 = time.perf_counter()
        with self._store(fov_name) as store:
            store.set_fov_info(fov_name=fov_name,
                               data_folder=self.data_folder)
            for dtype, pairs in table.items():
                store.init_data_type(
                    dtype, [rid for rid, _ in pairs],
                    channels=[ch for _, ch in pairs],
                    spot_capacity=self.spot_capacity,
                    overwrite=overwrite)
            pending = {dtype: set(store.pending_regions(dtype).tolist())
                       for dtype in table}
            self.timings.add("store_open", time.perf_counter() - t0,
                             backend=store.backend)
            todo = [p for p in self._plans
                    if any(rid in pending[dt] for dt, rid in p.regions)]
            if not todo:
                return processed

            # checkpoint sink: async writer thread (default) or the
            # store directly; both expose save_spots/save_image/flush
            sink = AsyncFovWriter(store) if self.async_writes else store

            if self.sequential_drift:
                try:
                    self._process_sequential(fov_name, store, sink,
                                             pending, processed)
                finally:
                    self._drain_sink(sink)
                return processed

            ref_im = self._reference_image(fov_name)

            def flush(plan, res, ims, stage):
                """Wait for one round's device result and persist it; the
                round's time is its dispatch's plus this wait."""
                t0 = time.perf_counter()
                self._sync()
                stage["seconds"] += time.perf_counter() - t0
                with self.timings.stage("save"):
                    drift = res.drift.cpu().numpy()
                    dflag = int(res.drift_flag)
                    spots = res.spots.cpu().numpy()
                    raw = res.raw_spots.cpu().numpy()
                    valid = res.valid.cpu().numpy()
                    corrected_ims = None
                    if self.save_images:
                        corrected_ims = self._pipeline_for(plan).correct(
                            self._to_stack(ims)).cpu().numpy()
                    for ci, (dtype, rid) in zip(plan.fit_channel_indices,
                                                plan.regions):
                        if rid not in pending[dtype]:
                            continue
                        sel = valid[ci]
                        sink.save_spots(dtype, rid, spots[ci][sel],
                                        raw[ci][sel], drift,
                                        flag=FLAG_CORRECTED,
                                        drift_flag=dflag)
                        if corrected_ims is not None:
                            sink.save_image(dtype, rid, corrected_ims[ci])
                        processed[dtype] += 1
                    sink.flush()

            # one-round readahead: round r+1 goes to the device before
            # round r is persisted, and a loader thread reads round r+1's
            # .dax meanwhile (the analog of the reference worker pool,
            # classes/field_of_view.py:1128-1142)
            try:
                in_flight = None
                for plan, ims in self._iter_rounds(todo, fov_name):
                    pipe = self._pipeline_for(plan)
                    with self.timings.stage(
                            "process_round",
                            folder=self._folder_key(plan.folder)) as stage:
                        res = self._dispatch_round(pipe, ims, ref_im)
                    if in_flight is not None:
                        flush(*in_flight)
                    in_flight = (plan, res, ims, stage)
                if in_flight is not None:
                    flush(*in_flight)
            finally:
                self._drain_sink(sink)
        return processed

    def _iter_rounds(self, todo, fov_name: str, depth: int = 2):
        """Yield (plan, host round) with reads running on a background
        thread, at most `depth` rounds resident at once.  Errors are
        re-raised at the consumer's next pull."""
        done = object()
        q: "queue.Queue" = queue.Queue(maxsize=max(depth - 1, 1))

        def run():
            try:
                for plan in todo:
                    q.put((plan, self._load_round(plan, fov_name)))
                q.put(done)
            except BaseException as e:      # noqa: BLE001 — relayed
                q.put(e)

        t = threading.Thread(target=run, daemon=True,
                             name="round-loader")
        t.start()
        while True:
            item = q.get()
            if item is done:
                t.join()
                return
            if isinstance(item, BaseException):
                t.join()
                raise RuntimeError("round load failed") from item
            yield item

    def _drain_sink(self, sink) -> None:
        """Complete all queued checkpoint writes (no-op for a bare store)."""
        if isinstance(sink, AsyncFovWriter):
            with self.timings.stage("save_drain"):
                sink.close()

    def _process_sequential(self, fov_name: str, store: FovStore,
                            sink, pending, processed) -> None:
        """Sequential drift mode: each round registers against the
        previous round's corrected drift-channel image; stored drifts are
        the cumulative sums vs round 0 (reference Calculate_Bead_Drift
        sequential mode, corrections.py:21-278).

        Resume is per-round: a fully-saved round contributes its *stored*
        cumulative drift to the chain (the reference resumes sequential
        chains from the saved drift dict, corrections.py:96-140) and is
        neither re-fit nor re-corrected — only the round immediately
        preceding the first pending round is re-corrected to rebuild the
        registration target."""
        cum = np.zeros(3, np.float32)
        prev_im = None
        prev_plan = None
        for plan in self._plans:
            round_pending = any(rid in pending[dt]
                                for dt, rid in plan.regions)
            if not round_pending:
                # adopt the stored cumulative drift; defer image work
                # until a pending round actually needs the target
                dt0, rid0 = plan.regions[0]
                cum = np.asarray(store.load_spots(dt0, rid0)[1], np.float32)
                prev_plan, prev_im = plan, None
                continue
            pipe = self._pipeline_for(plan)
            if prev_im is None and prev_plan is not None:
                prev_im = self._pipeline_for(prev_plan).correct_reference(
                    self._to_stack(self._load_round(prev_plan, fov_name)))
            ims = self._to_stack(self._load_round(plan, fov_name))
            with self.timings.stage("process_round",
                                    folder=self._folder_key(plan.folder)):
                if prev_im is None:
                    prev_im = pipe.correct_reference(ims)
                # one pass corrects, registers, fits AND returns the
                # corrected drift channel as the next round's registration
                # target: exactly one correction per round
                res, prev_im = pipe.process_round_returning_ref(ims, prev_im)
                prev_plan = plan
                self._sync()
            step = res.drift.cpu().numpy()
            prev_cum = cum.copy()
            cum = cum + step
            dflag = int(res.drift_flag)
            spots = res.spots.cpu().numpy()
            raw = res.raw_spots.cpu().numpy()
            valid = res.valid.cpu().numpy()
            for ci, (dtype, rid) in zip(plan.fit_channel_indices,
                                        plan.regions):
                if rid not in pending[dtype]:
                    continue
                sel = valid[ci]
                # res.spots carry chromatic + step-drift correction;
                # adding the previous cumulative maps into round 0's frame
                corr = spots[ci][sel].copy()
                corr[:, 1:4] += prev_cum[None]
                sink.save_spots(dtype, rid, corr, raw[ci][sel], cum,
                                flag=FLAG_CORRECTED, drift_flag=dflag)
                processed[dtype] += 1
            sink.flush()

    def process_all(self, overwrite: bool = False) -> Dict[str, Dict[str, int]]:
        """Process every FOV in the experiment; returns per-FOV counts."""
        return {fov: self.process_fov(fov, overwrite=overwrite)
                for fov in self.fovs}

    # -- chromosome image ---------------------------------------------------

    def _marker_plan(self, marker: str) -> Optional[Tuple[RoundPlan, int]]:
        """(plan, channel index) for a dedicated marker round ('chrom' or
        'dapi' entry in Color_Usage; reference _load_chromosome_image
        classes/field_of_view.py:1716-1820 and _load_dapi_image
        classes/__init__.py:2649-2686 locate the folder the same way)."""
        cu = self.color_usage
        bead_ch = self._bead_channel()
        for folder in self.folders:
            entries = cu.usage.get(self._folder_key(folder))
            if not entries:
                continue
            for ch, info in zip(cu.channels, entries):
                if info and marker in info.lower():
                    channels = [ch] + ([bead_ch] if bead_ch != ch else [])
                    plan = RoundPlan(
                        folder=folder, channels=channels,
                        fit_channel_indices=[0], regions=[(marker, 0)],
                        drift_channel_index=channels.index(bead_ch))
                    return plan, 0
        return None

    def _chrom_plan(self) -> Optional[Tuple[RoundPlan, int]]:
        return self._marker_plan("chrom")

    def _aligned_marker(self, fov_name: str, plan: RoundPlan,
                        ci: int) -> np.ndarray:
        """A marker round's channel `ci`, corrected and drift-aligned to
        the reference round."""
        pipe = self._pipeline_for(plan)
        corrected = pipe.correct(self._to_stack(
            self._load_round(plan, fov_name)))
        if plan.folder != self.ref_folder:
            drift, _flag = pipe.drift_of(
                corrected[plan.drift_channel_index],
                self._reference_image(fov_name))
        else:
            drift = torch.zeros(3, dtype=torch.float32)
        return warp_image_drift(corrected[ci], drift).cpu().numpy()

    def load_dapi_image(self, fov_name: str, save: bool = True,
                        overwrite: bool = False) -> np.ndarray:
        """Corrected, drift-aligned DAPI stack for one FOV, cached in the
        store's `signal` group as `dapi_im`.

        Behavior target: Cell_Data._load_dapi_image
        (classes/__init__.py:2649-2686): pick the DAPI-marked folder from
        Color_Usage, run the correction chain on that channel, align it to
        the reference round.  The reference crops to the cell's
        segmentation box; here the full FOV is kept."""
        with self._store(fov_name) as store:
            if not overwrite:
                cached = store.load_signal("dapi_im")
                if cached is not None:
                    return cached
            found = self._marker_plan("dapi")
            if found is None:
                raise ValueError("no DAPI-marked round in Color_Usage "
                                 "(reference raises the same)")
            plan, ci = found
            out = self._aligned_marker(fov_name, plan, ci)
            if save:
                store.save_signal("dapi_im", out, source=plan.folder)
            return out

    def generate_chromosome_image(self, fov_name: str,
                                  data_type: str = "unique",
                                  save: bool = True,
                                  overwrite: bool = False) -> np.ndarray:
        """Chromosome-paint stack for one FOV.

        Two sources, matching the reference (classes/field_of_view.py:
        1716-1935):
          * a dedicated 'chrom'-marked round in Color_Usage: corrected +
            drift-aligned directly (_load_chromosome_image);
          * otherwise the drift-aligned sum of every *processed* region
            image of `data_type` (_generate_chrom_im_from_data — the
            reference shifts each stored image by its saved drift and
            accumulates).
        The result is cached in the store's `signal` group as `chrom_im`.
        """
        with self._store(fov_name) as store:
            if not overwrite:
                cached = store.load_signal("chrom_im")
                if cached is not None:
                    return cached

            chrom = self._chrom_plan()
            if chrom is not None:
                out = self._aligned_marker(fov_name, *chrom)
                if save:
                    store.save_signal("chrom_im", out, source="chrom_round")
                return out

            # accumulate from processed data-type rounds
            acc = None
            n_added = 0
            g_ids = None
            for plan in self._plans:
                wanted = [(ci, rid) for ci, (dt, rid) in
                          zip(plan.fit_channel_indices, plan.regions)
                          if dt == data_type]
                if not wanted:
                    continue
                if g_ids is None:
                    g_ids = store.ids(data_type).tolist()
                    drifts = store.drifts(data_type)
                flags = store.flags(data_type)
                ready = [(ci, rid) for ci, rid in wanted
                         if rid in g_ids and
                         flags[g_ids.index(rid)] > FLAG_EMPTY]
                if not ready:
                    continue
                corrected = self._pipeline_for(plan).correct(
                    self._to_stack(self._load_round(plan, fov_name)))
                for ci, rid in ready:
                    shifted = warp_image_drift(corrected[ci],
                                               drifts[g_ids.index(rid)])
                    acc = shifted if acc is None else acc + shifted
                    n_added += 1
                del corrected
            if acc is None:
                raise RuntimeError(
                    f"no processed {data_type} images to combine; run "
                    "process_fov first (reference loads only flags>0 ids)")
            out = acc.cpu().numpy()
            if save:
                store.save_signal("chrom_im", out, source=data_type,
                                  n_images=n_added)
            return out

    def identify_chromosomes(self, fov_name: str,
                             nucleus_labels: Optional[np.ndarray] = None,
                             expected_per_nucleus: int = 2,
                             th_seed: Optional[float] = None,
                             save: bool = True,
                             **find_kwargs):
        """Chromosome candidate centers inside nuclei for one FOV
        (reference identify_chromosomes, segmentation_tools/chromosome.py:
        409-486 + classes/field_of_view.py:1936-2341): generate/load the
        chromosome image, seed candidates gated by the nucleus labels, and
        persist `chrom_coords` to the store's signal group."""
        chrom_im = self.generate_chromosome_image(fov_name, save=save)
        with self._store(fov_name) as store:
            if nucleus_labels is None:
                nucleus_labels = store.load_segmentation()
            if nucleus_labels is None:
                # no segmentation: the whole FOV is one nucleus
                nucleus_labels = np.ones(chrom_im.shape, np.int32)
            if th_seed is None:
                # adaptive: candidates must rise above the combined stack's
                # spread (the reference's per-cell adaptive threshold start)
                th_seed = float(3.0 * np.std(chrom_im))
            coords, labels, counts = find_candidate_chromosomes(
                chrom_im, nucleus_labels,
                expected_per_nucleus=expected_per_nucleus,
                th_seed=th_seed, device=self.device, **find_kwargs)
            if save:
                store.save_signal("chrom_coords", coords,
                                  expected_per_nucleus=expected_per_nucleus)
                store.save_signal("chrom_labels", labels)
        return coords, labels, counts

    def load_region_crops(self, fov_name: str, crop_limits,
                          data_type: str,
                          region_ids: Optional[Sequence[int]] = None,
                          correct_illumination: bool = True
                          ) -> Dict[int, np.ndarray]:
        """Per-region crops loaded straight from the raw .dax files —
        without reading any full FOV stack.

        The disk side of Cell_Data._crop_images
        (classes/__init__.py:2780-2962) for runs without
        ``save_images=True``: for each requested region, read only the
        drift-expanded crop window of its round's movie
        (io.read_channel_crops), flat-field the window against the
        channel's illumination profile slice, and resample onto the
        drift-corrected grid on the driver's device using the drift
        persisted by :meth:`process_fov`.  Quick-correction semantics
        (hot-pixel, z-shift and bleedthrough are full-stack statistics and
        are NOT applied — matching the reference's cropped quick path,
        classes/batch_functions.py:60-302 correction subset on crops).

        ``crop_limits``: 2x2 (x/y, full z) or 3x2 (z/x/y) in corrected-
        frame pixels.  Returns {region_id: (dz, dx, dy) float32 crop}.
        """
        size = tuple(int(s) for s in self.cfg.image_size)
        lims = _normalize_crop_limits(crop_limits, size)
        out: Dict[int, np.ndarray] = {}
        with self._store(fov_name, "r") as store:
            ids = store.ids(data_type).tolist()
            drifts = store.drifts(data_type)
        for plan in self._plans:
            wanted = [(ci, rid) for ci, (dt, rid) in
                      zip(plan.fit_channel_indices, plan.regions)
                      if dt == data_type and rid in ids and
                      (region_ids is None or rid in set(region_ids))]
            if not wanted:
                continue
            pipe = self._pipeline_for(plan)
            path = os.path.join(plan.folder, fov_name)
            for ci, rid in wanted:
                d = np.asarray(drifts[ids.index(rid)], np.float64)
                pad = np.ceil(np.abs(d)).astype(np.int64)
                read_lims = np.stack(
                    [np.maximum(lims[:, 0] - pad, 0),
                     np.minimum(lims[:, 1] + pad, size)], axis=1)
                (raw,) = read_channel_crops(
                    path, [plan.channels[ci]], read_lims,
                    all_channels=self.color_usage.channels,
                    n_z=size[0],
                    buffer_frames=self.cfg.num_buffer_frames,
                    empty_frames=self.cfg.num_empty_frames)
                crop = raw.astype(np.float32)
                if (correct_illumination
                        and pipe.illumination is not None
                        and self.cfg.correction.illumination):
                    prof = pipe.illumination[ci][
                        read_lims[1, 0]:read_lims[1, 1],
                        read_lims[2, 0]:read_lims[2, 1]].cpu().numpy()
                    crop = crop / prof[None]
                offs = lims[:, 0] - read_lims[:, 0] - d
                shape = tuple(int(lims[a, 1] - lims[a, 0])
                              for a in range(3))
                if np.any(offs != 0) or crop.shape != shape:
                    crop = resample_window(crop, offs, shape,
                                           device=self.device)
                out[int(rid)] = crop
        return out

    def select_chromosomes_by_spots(self, fov_name: str,
                                    data_type: str = "unique",
                                    cand_spot_intensity_th: float = 0.5,
                                    good_chr_loss_th: float = 0.4,
                                    save: bool = True) -> np.ndarray:
        """Screen this FOV's candidate chromosome centers by fitted-spot
        support and persist the survivors.

        Behavior target: _select_chromosome_by_candidate_spots
        (classes/field_of_view.py:2273-2341): candidates come from
        :meth:`identify_chromosomes` (`chrom_coords` signal), spots from
        every processed region of ``data_type``; chromosomes losing more
        than ``good_chr_loss_th`` of rounds are iteratively removed
        (segmentation.select_candidate_chromosomes).  Intensities are
        normalized by their median before the threshold, matching the
        reference's normalized-intensity screen.
        """
        with self._store(fov_name) as store:
            cands = store.load_signal("chrom_coords")
            if cands is None:
                raise RuntimeError("no chrom_coords in store; run "
                                   "identify_chromosomes first")
            spots_by_region = store.load_all_spots(data_type)
            spots_list = []
            for rid in sorted(spots_by_region):
                s = np.asarray(spots_by_region[rid], np.float64).copy()
                if len(s):
                    med = np.median(s[:, 0])
                    if med > 0:
                        s[:, 0] = s[:, 0] / med
                spots_list.append(s)
            coords, kept = select_candidate_chromosomes(
                np.asarray(cands, np.float64), spots_list,
                cand_spot_intensity_th=cand_spot_intensity_th,
                good_chr_loss_th=good_chr_loss_th, device=self.device)
            if save:
                store.save_signal("chrom_coords", coords,
                                  screened_by=data_type,
                                  n_candidates=int(len(kept)))
        return coords
