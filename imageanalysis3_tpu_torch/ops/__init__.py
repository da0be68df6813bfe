"""Numerical ops on tensors; two of them carry hand-written CUDA kernels
(``seed_kernels``, ``lm_kernel``) beside their plain PyTorch versions."""

from . import lm_kernel, seed_kernels

#: kernel name -> module whose `launches` counter its wrapper bumps
_KERNEL_MODULES = {"seed_pyramid": seed_kernels, "lm_fit": lm_kernel}


def kernel_launches() -> dict:
    """Launch count of each CUDA kernel since the last reset."""
    return {name: mod.launches for name, mod in _KERNEL_MODULES.items()}


def reset_kernel_launches() -> None:
    """Set every kernel's launch count to 0."""
    for mod in _KERNEL_MODULES.values():
        mod.launches = 0
