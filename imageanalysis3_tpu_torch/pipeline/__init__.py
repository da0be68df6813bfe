"""Pipeline orchestration: per-FOV round processing and the stepwise
per-.dax facade."""

from .dax_processer import DaxProcesser, batch_process_image_quick
from .fov import FovPipeline, RoundResult

__all__ = ["FovPipeline", "RoundResult", "DaxProcesser",
           "batch_process_image_quick"]
