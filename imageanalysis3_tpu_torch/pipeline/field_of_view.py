"""Field_of_View facade: the reference's per-FOV workflow, slimmed.

The counterpart of ``imageanalysis3_tpu/pipeline/field_of_view.py``.
Behavior target: reference classes/field_of_view.py:44-2621
(Field_of_View): one object owning a FOV's folders, save file, drift,
spot tables and downstream picking.  It composes the port's
``ExperimentDriver`` (scan, correct, drift, fit, persist with resume), the
candidate-table builder, the EM and naive pickers and the distance map
into the reference's workflow methods:

    fov = FieldOfView(data_folder, save_folder, fov_name)
    fov.process_image_to_spots()              # :901-1158
    cands = fov.load_candidate_spots("unique")
    res = fov.pick_spots(method="EM")         # legacy _pick_spots :3733
    dm = fov.distance_map(res.trace)          # _generate_distance_map :4123

The store is read through its public methods only (``drifts``,
``drift_flags``, ``load_all_spots``), whichever backend wrote it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..analysis.distmap import distance_map, spots_to_zxy_nm
from ..config import DEFAULT_PIXEL_SIZE_NM, ExperimentConfig
from ..decode.picking import (EMPickResult, build_candidate_table,
                              em_pick_spots, naive_pick_spots)
from ..device import as_tensor, resolve_device
from ..io.store import FovStore
from .experiment import ExperimentDriver


class FieldOfView:
    """Per-FOV workflow facade over the port's driver and pickers.
    `driver_kwargs` go to ``ExperimentDriver`` (its ``device`` included)."""

    def __init__(self, data_folder: str, save_folder: str, fov_name: str,
                 cfg: Optional[ExperimentConfig] = None, **driver_kwargs):
        self.fov_name = fov_name
        self.driver = ExperimentDriver(data_folder, save_folder, cfg=cfg,
                                       **driver_kwargs)
        if fov_name not in self.driver.fovs:
            raise FileNotFoundError(
                f"{fov_name} not among {self.driver.fovs}")

    # -- acquisition -> spots ---------------------------------------------

    def process_image_to_spots(self, overwrite: bool = False
                               ) -> Dict[str, int]:
        """Correct + register + fit every pending round (reference
        _process_image_to_spots, classes/field_of_view.py:901-1158)."""
        return self.driver.process_fov(self.fov_name, overwrite=overwrite)

    @property
    def store_path(self) -> str:
        return self.driver.store_path(self.fov_name)

    def _store(self) -> FovStore:
        return FovStore(self.store_path, "r",
                        backend=self.driver.store_backend)

    def load_candidate_spots(self, data_type: str = "unique"
                             ) -> Dict[int, np.ndarray]:
        """region id -> (n, 11) corrected spots from the save file."""
        with self._store() as store:
            return store.load_all_spots(data_type)

    def drifts(self, data_type: str = "unique"
               ) -> Tuple[np.ndarray, np.ndarray]:
        """The data type's stored (n, 3) drifts and drift flags."""
        with self._store() as store:
            return store.drifts(data_type), store.drift_flags(data_type)

    # -- picking -----------------------------------------------------------

    def candidate_table(self, data_type: str = "unique",
                        capacity: Optional[int] = None):
        spots = self.load_candidate_spots(data_type)
        return build_candidate_table(spots, capacity=capacity)

    def pick_spots(self, data_type: str = "unique", method: str = "EM",
                   chrom_center: Optional[np.ndarray] = None, device=None,
                   **pick_kwargs) -> EMPickResult:
        """Candidate spots -> one chromosome trace (reference
        Cell_Data._pick_spots, classes/__init__.py:3733-4038; methods
        'EM' and 'naive'), on `device` (the CUDA card unless "cpu")."""
        dev = resolve_device(device)
        cand, valid, ids = (as_tensor(a, dev)
                            for a in self.candidate_table(data_type))
        center = (None if chrom_center is None
                  else as_tensor(np.asarray(chrom_center, np.float32), dev))
        if method.upper() == "EM":
            return em_pick_spots(cand, valid, ids, chrom_center=center,
                                 device=dev, **pick_kwargs)
        trace, has = naive_pick_spots(cand, valid, center, device=dev)
        sel = torch.where(valid, cand[..., 0], float("-inf")).argmax(dim=1)
        return EMPickResult(
            trace=trace, sel_idx=sel, sel_valid=has,
            scores=torch.where(has, 0.0, float("nan")),
            n_iters=torch.tensor(0, dtype=torch.int32, device=dev),
            change_ratio=torch.tensor(0.0, device=dev))

    # -- analysis -----------------------------------------------------------

    def distance_map(self, trace, pixel_size_nm=DEFAULT_PIXEL_SIZE_NM,
                     device=None) -> np.ndarray:
        """Picked trace (R, 11) -> (R, R) nm distance map (reference
        _generate_distance_map, classes/__init__.py:4123-4273), computed
        on `device` (the CUDA card unless "cpu")."""
        dev = resolve_device(device)
        trace = as_tensor(trace, dev).to(torch.float32)
        return distance_map(spots_to_zxy_nm(trace, pixel_size_nm)
                            ).cpu().numpy()
