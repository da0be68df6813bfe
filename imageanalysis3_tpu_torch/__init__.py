"""imageanalysis3_tpu_torch: the PyTorch/CUDA port of imageanalysis3_tpu.

One hybridization round of one FOV -- corrections, drift consensus,
pyramid-background seeding, the fused LM Gaussian fit and the coordinate
warp -- in PyTorch, with hand-written CUDA kernels (``csrc/``) for the
seeding classifier and the LM fit.  Entry points run on the CUDA card
unless the caller passes ``device="cpu"``; on the CPU every kernel runs as
its plain PyTorch version.  The package imports neither JAX nor
``imageanalysis3_tpu``.
"""

from .config import (CorrectionConfig, DriftConfig, ExperimentConfig,
                     FitConfig, SeedConfig, config_from_dict)
from .pipeline import FovPipeline, RoundResult

__all__ = ["CorrectionConfig", "DriftConfig", "ExperimentConfig",
           "FitConfig", "SeedConfig", "config_from_dict", "FovPipeline",
           "RoundResult"]
