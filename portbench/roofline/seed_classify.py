"""``csrc/seed_classify.cu``: one launch classifies one corrected
(Z, X, Y) float32 channel whose z passes are done (its fg and bg stacks)
against its exact background.

Bytes: the two z-passed stacks read and the qdiff map written (4 B a voxel
each) and the level counts written.  Operations a voxel: on the CUDA
cores, the fg's x and y passes (`taps_fg` products and taps_fg - 1 sums
each), 26 maxima, 26 minima, the difference and two compares
(chip_smoke.py's count, without its 4 a qualifying voxel, which the
configuration does not fix); on the tensor cores, the bg's x and y passes
(`taps_bg` products and sums each), three TF32 products each (the split:
hi x hi, hi x lo, lo x hi).  The least time is the larger of the bytes at
the peak bandwidth and the CUDA-core operations at the f32 peak plus the
tensor-core ones at the dense TF32 peak (TF32_DENSE)."""

from __future__ import annotations

import numpy as np

from ..reference.filters import gaussian_kernel1d

#: dense TF32 tensor-core FLOP/s by part: NVIDIA's H100 data sheet gives
#: 989 (SXM), 835 (NVL) and 756 (PCIe) TFLOPS with sparsity, twice the
#: dense rate
TF32_DENSE = {"SXM": 494.5e12, "NVL": 417.5e12, "PCIe": 378.0e12}


def _part(pk) -> str:
    label = pk[2]
    return next((p for p in ("PCIe", "NVL") if p in label), "SXM")


def counts(config: dict):
    """(bytes, CUDA-core operations, TF32 tensor-core operations) of one
    launch."""
    nvox = float(np.prod(config["shape"]))
    s = config["pipeline"]["seed"]
    n_lvl = s["dynamic_niters"] if s["use_dynamic_th"] else 1
    kf = len(gaussian_kernel1d(s["gfilt_size"]))
    kb = len(gaussian_kernel1d(s["background_gfilt_size"]))
    nbytes = 4 * nvox * 3 + 4 * n_lvl
    cuda_ops = nvox * (2 * (2 * kf - 1) + 55)
    tensor_ops = nvox * 3 * 2 * (2 * kb)
    return nbytes, cuda_ops, tensor_ops


def least(config: dict, pk):
    """(least seconds of one launch, what bounds it)."""
    nbytes, cuda_ops, tensor_ops = counts(config)
    t_b = nbytes / pk[0]
    t_o = cuda_ops / pk[1] + tensor_ops / TF32_DENSE[_part(pk)]
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
