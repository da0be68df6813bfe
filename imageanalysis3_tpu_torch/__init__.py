"""imageanalysis3_tpu_torch: the PyTorch/CUDA port of imageanalysis3_tpu.

One hybridization round of one FOV -- corrections, drift consensus,
seeding (pyramid-background or exact classifier), the fused LM Gaussian fit
and the coordinate warp -- and the end-to-end path beyond it: MERFISH
decoding of the rounds' spots and homolog E/M traces (``decode``) -- and
the bead calibration that makes the round's correction profiles
(``ops.profiles``, written and read by ``io``) -- and, after the spots
are stored, picking them into chromosome traces (``decode``), distance
maps (``analysis``) and the per-FOV ``pipeline.FieldOfView`` facade -- and
the figures (``figures``: matplotlib, imported inside its functions; its
``SpotBrowser`` seeds and fits on the card) and the legacy Cell_List /
Cell_Data workflow (``legacy``).  In PyTorch, with
hand-written CUDA kernels (``csrc/``) for the seeding classifiers, the dual
blur, the level stencil, the LM fit and the cube gather.  Entry points
run on the CUDA card unless the caller passes ``device="cpu"``; on the CPU
every kernel runs as its plain PyTorch version.  The package imports
neither JAX, nor ``imageanalysis3_tpu``, nor pandas.
"""

from .config import (ALLOWED_COLORS, CORR_CHANNELS, DEFAULT_IMAGE_SIZE,
                     DEFAULT_PIXEL_SIZE_NM, DEFAULT_SIGMA_ZXY,
                     CorrectionConfig, DriftConfig, ExperimentConfig,
                     FitConfig, SeedConfig, config_from_dict)
from .pipeline import FovPipeline, RoundResult

__version__ = "0.2.0"

__all__ = ["DEFAULT_PIXEL_SIZE_NM", "DEFAULT_SIGMA_ZXY", "DEFAULT_IMAGE_SIZE",
           "ALLOWED_COLORS", "CORR_CHANNELS", "CorrectionConfig",
           "DriftConfig", "ExperimentConfig", "FitConfig", "SeedConfig",
           "config_from_dict", "FovPipeline", "RoundResult"]
