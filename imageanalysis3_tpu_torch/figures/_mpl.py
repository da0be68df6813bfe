"""Matplotlib backend selection for the figures package.

The port's own copy of ``imageanalysis3_tpu/figures/_mpl.py``, with one
difference: matplotlib is imported inside :func:`pyplot`, never when a
module of the package is imported, so ``figures`` and ``legacy`` import
on a machine without matplotlib.

Default to Agg only when the process is truly headless AND matplotlib
is not already configured — never hijack a notebook's interactive
backend.  `matplotlib.use("Agg", force=False)` is NOT that: force=False
only suppresses import errors, so with pyplot already imported it still
switches the live backend (closing open figures), and otherwise it
still overrides rcParams.  Guard on all three signals instead.
"""

import os
import sys


def ensure_headless_backend() -> None:
    if "matplotlib.pyplot" in sys.modules:
        return                    # caller already chose (e.g. notebook)
    if os.environ.get("MPLBACKEND") or os.environ.get("DISPLAY"):
        return                    # explicit choice / display available
    import matplotlib
    try:
        matplotlib.use("Agg")
    except Exception:
        pass


def pyplot():
    """``matplotlib.pyplot``, imported on first use behind
    :func:`ensure_headless_backend`."""
    ensure_headless_backend()
    import matplotlib.pyplot as plt
    return plt
