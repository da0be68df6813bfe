"""Where the package's entry points run.

The default device is the CUDA card; without one, an entry point raises
unless the caller asks for the CPU (``device="cpu"``).  NumPy inputs go to
that device; tensors stay where they are, and their device then picks
kernel or plain version.

Small constants an op builds on the host (index maps, band matrices,
weights) are copied to their device once and kept
(:func:`device_constant`): a copy from pageable host memory makes the host
wait for the card, and a round would otherwise wait at each such copy.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable

import numpy as np
import torch

from . import tracing

#: the most constants, and the most bytes of them, kept over all devices;
#: the least recently used go first
CONST_ENTRIES = 256
CONST_BYTES = 256 << 20

_consts: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
_consts_lock = threading.Lock()


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


def device_constant(key: tuple, dtype: torch.dtype, device,
                    build: Callable) -> torch.Tensor:
    """The constant `build()` (anything ``torch.as_tensor`` takes) as a
    `dtype` tensor on `device`, built and copied there on the first call
    for (`key`, `dtype`, `device`) and the same tensor on every later one.
    `key` holds everything the value depends on.  Callers never write into
    the tensor.  Each build counts one ``const_builds`` (``tracing``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    k = (key, dtype, dev)
    with _consts_lock:
        t = _consts.get(k)
        if t is not None:
            _consts.move_to_end(k)
            return t
        t = torch.as_tensor(build(), dtype=dtype).to(dev, copy=True)
        tracing.count("const_builds")
        size = t.untyped_storage().nbytes()
        if size <= CONST_BYTES:
            _consts[k] = t
            total = sum(v.untyped_storage().nbytes() for v in _consts.values())
            while len(_consts) > CONST_ENTRIES or total > CONST_BYTES:
                _, old = _consts.popitem(last=False)
                total -= old.untyped_storage().nbytes()
        return t
