"""What a profiler trace of a steady span of whole units says: the
device's busy time, each kernel's launches and device time, the
host-to-device copies, and the idle gaps by what the host was doing.

Device time comes from torch.profiler's CUDA activity (CUPTI), host
activity from its CPU events; both are in the profiler's own microseconds.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from .peaks import function_name

#: gaps labelled one by one; the rest are summed as short gaps
LABELLED_GAPS = 400


@dataclass
class TraceSummary:
    window_s: float                       # host clock over the span
    busy_s: float                         # union of device activity
    kernels: Dict[str, List[float]]       # name -> [launches, seconds]
    h2d_s: float
    h2d_count: int
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    counts: Dict[str, int] = field(default_factory=dict)  # units, rounds, fits

    def kernel(self, pattern: str) -> Tuple[int, float]:
        """Launches and device seconds of every kernel whose name matches
        the regular expression `pattern`."""
        n, s = 0, 0.0
        for name, (c, t) in self.kernels.items():
            if re.search(pattern, name):
                n, s = n + int(c), s + t
        return n, s


def _merged(intervals: np.ndarray) -> np.ndarray:
    if not len(intervals):
        return intervals
    iv = intervals[np.argsort(intervals[:, 0])]
    out = [list(iv[0])]
    for a, b in iv[1:]:
        if a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.asarray(out)


def capture(torch, fn, counts: Dict[str, int]) -> TraceSummary:
    """Run `fn` (a span of whole units) under torch.profiler and
    summarise it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return summarize(torch, prof.events(), wall, counts)


def summarize(torch, events, wall: float, counts: Dict[str, int]
              ) -> TraceSummary:
    cuda = torch.autograd.DeviceType.CUDA
    dev, cpu = [], []
    for ev in events:
        tr = ev.time_range
        row = (ev.name, float(tr.start), float(tr.end))
        if ev.device_type != cuda:
            cpu.append(row)
        elif not ev.name.startswith("portbench."):
            # the benchmark's own ranges come back as device-side
            # annotations too; they are no device activity
            dev.append(row)
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    kernels: Dict[str, List[float]] = {}
    h2d_s, h2d_n = 0.0, 0
    for name, a, b in dev:
        if name.startswith("Memcpy HtoD"):
            h2d_s += (b - a) / 1e6
            h2d_n += 1
        key = name if name.startswith("Mem") else function_name(name)
        k = kernels.setdefault(key, [0, 0.0])
        k[0] += 1
        k[1] += (b - a) / 1e6
    busy_iv = _merged(np.asarray([(a, b) for _, a, b in dev], np.float64))
    busy_s = float((busy_iv[:, 1] - busy_iv[:, 0]).sum()) / 1e6
    # idle gaps inside the span the host was active in
    lo = min(a for _, a, _ in cpu) if cpu else busy_iv[0, 0]
    hi = max(max(b for _, _, b in cpu) if cpu else 0.0, busy_iv[-1, 1])
    edges = np.concatenate([[lo], busy_iv.reshape(-1), [hi]]).reshape(-1, 2)
    gaps = edges[(edges[:, 1] - edges[:, 0]) > 0]
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])]
    names = [n for n, _, _ in cpu]
    starts = np.asarray([a for _, a, _ in cpu], np.float64)
    ends = np.asarray([b for _, _, b in cpu], np.float64)
    spans = np.asarray([n.startswith("portbench.") for n in names])
    by_label: Dict[str, float] = {}
    for k, (a, b) in enumerate(gaps):
        sec = (b - a) / 1e6
        if k >= LABELLED_GAPS or not len(names):
            by_label["short gaps, unlabelled"] = \
                by_label.get("short gaps, unlabelled", 0.0) + sec
            continue
        mid = 0.5 * (a + b)
        inside = (starts <= mid) & (ends >= mid)
        label = "host idle"
        if inside.any():
            ops = np.where(inside & ~spans)[0]
            outer = np.where(inside & spans)[0]
            op = (names[ops[np.argmin(ends[ops] - starts[ops])]]
                  if len(ops) else "")
            sp = (names[outer[np.argmin(ends[outer] - starts[outer])]]
                  if len(outer) else "")
            label = " / ".join(x for x in (sp, op) if x) or label
        by_label[label] = by_label.get(label, 0.0) + sec
    ops = sorted(((k, v[1]) for k, v in kernels.items()), key=lambda x: -x[1])
    return TraceSummary(
        window_s=wall, busy_s=busy_s, kernels=kernels, h2d_s=h2d_s,
        h2d_count=h2d_n, device_ops=[[k, v] for k, v in ops[:10]],
        idle_gaps=[[k, v] for k, v in sorted(by_label.items(),
                                               key=lambda x: -x[1])[:10]],
        counts=dict(counts))
