"""Pipeline orchestration: per-FOV round processing, the stepwise per-.dax
facade, the experiment driver (hyb folders -> per-FOV spot stores) and the
per-FOV workflow facade (spots -> picked trace -> distance map)."""

from .dax_processer import DaxProcesser, batch_process_image_quick
from .experiment import (DATA_TYPE_PREFIXES, ExperimentDriver, RawRound,
                         RoundPlan, StageTimes, parse_region_entry)
from .field_of_view import FieldOfView
from .fov import FovPipeline, RoundResult

__all__ = ["FovPipeline", "RoundResult", "DaxProcesser",
           "batch_process_image_quick", "ExperimentDriver", "RoundPlan",
           "RawRound", "StageTimes", "parse_region_entry",
           "DATA_TYPE_PREFIXES", "FieldOfView"]
