"""Where the package's entry points run.

The default device is the CUDA card; without one, an entry point raises
unless the caller asks for the CPU (``device="cpu"``).  NumPy inputs go to
that device; tensors stay where they are, and their device then picks
kernel or plain version.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA card when None; raises when CUDA is asked for
    (explicitly or by default) and no CUDA device exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "imageanalysis3_tpu_torch runs on a CUDA device and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def as_tensor(x, device=None) -> torch.Tensor:
    """`x` itself when it is a tensor; otherwise (a NumPy array, a list) a
    tensor of it on :func:`resolve_device` (`device`)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))


def host_array(x) -> np.ndarray:
    """`x` on the host as NumPy: a tensor copied back from its device,
    anything else through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
