"""Numerical ops on tensors; six of them carry hand-written CUDA kernels
(``seed_kernels``: seed_pyramid, seed_classify, dual_blur, level_stencil;
``lm_kernel``: lm_fit; ``gather_kernel``: gather_cubes, whose cube and ball
entries count as its launches) beside their plain PyTorch versions."""

from . import gather_kernel, lm_kernel, seed_kernels


def kernel_launches() -> dict:
    """Launch count of each CUDA kernel since the last reset."""
    return {**seed_kernels.launches, "lm_fit": lm_kernel.launches,
            "gather_cubes": gather_kernel.launches}


def reset_kernel_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in seed_kernels.launches:
        seed_kernels.launches[name] = 0
    lm_kernel.launches = 0
    gather_kernel.launches = 0
