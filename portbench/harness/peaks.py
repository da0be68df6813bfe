"""Published peaks of the card and the least time of a kernel's work.

Copied from chip_smoke.py (``_peaks``, ``_bound``, ``_function_name``) so
that a change to the program cannot move the yardstick.  Peaks are
NVIDIA's data-sheet numbers at the full power limit (700 W for the SXM
part): dense float32 outside the tensor cores and HBM bandwidth.
"""

from __future__ import annotations

import re
from typing import Tuple


def peaks(name: str) -> Tuple[float, float, str]:
    """(bytes/s, float32 FLOP/s, label) published for this H100 part."""
    if "PCIe" in name:
        return 2.0e12, 51.2e12, "H100 PCIe: 2.0 TB/s, 51.2 TFLOP/s f32"
    if "NVL" in name:
        return 3.9e12, 60.0e12, "H100 NVL: 3.9 TB/s, 60 TFLOP/s f32"
    return 3.35e12, 67.0e12, "H100 SXM: 3.35 TB/s, 67 TFLOP/s f32"


def least_seconds(nbytes: float, nops: float, pk) -> Tuple[float, str]:
    """The larger of bytes over peak bandwidth and operations over peak
    FLOP/s, and which of the two bounds it."""
    t_b, t_o = nbytes / pk[0], nops / pk[1]
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def function_name(name: str) -> str:
    """A kernel's own identifier from a profiler name: the demangled
    ``void ns::foo_kernel<4>(...)`` form or an Itanium-mangled one, with a
    template radius or flag kept as <R>."""
    m = re.search(r"(\w+_kernel)(<[^()]*>)?\(", name)
    if m:
        return m.group(1) + (m.group(2) or "")
    found = []
    for m in re.finditer(r"\d+", name):
        digits = m.group()
        for k in range(len(digits)):
            start, n = m.end(), int(digits[k:])
            ident = name[start:start + n]
            if re.fullmatch(r"[A-Za-z_]\w*(kernel|selftest|rate)", ident):
                found.append((n, start))
    if not found:
        return name[:120]
    n, start = min(found)
    ident = name[start:start + n]
    t = re.match(r"IL([ib])(\d+)E", name[start + n:])
    if not t:
        return ident
    arg = t.group(2)
    if t.group(1) == "b":
        arg = "true" if arg == "1" else "false"
    return ident + f"<{arg}>"
