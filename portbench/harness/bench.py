"""One run of one cell: set up, warm up, measure for the window, read the
per-layer metrics in a traced run, then check the window's answers
against the plain reference and print the result line."""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, Optional

from . import timeline
from .cell import Context, set_tf32
from .peaks import peaks
from .spec import Spec, driver_class, load_spec, metric_reader, roofline

#: top-level modules the process may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "imageanalysis3_tpu")


def process_age() -> Optional[float]:
    """Seconds since this process started, from /proc (None elsewhere)."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class RunRecord:
    """What the per-layer metric readers read."""

    def __init__(self, spec: Spec, trace, stages, peaks_):
        self.spec, self.config = spec, spec.config
        self.trace, self.stages, self.peaks = trace, stages, peaks_

    def roofline(self, kernel: str):
        return roofline(kernel)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", spec: Optional[Spec] = None,
             t0: Optional[float] = None, driver_hook=None,
             control: bool = False) -> dict:
    """Run one cell once and return the result line as a dict (with
    ``_stages`` and ``_summary`` for the earlier lines, and ``_numbers``,
    every number compared or read, limited or not).  `driver_hook`,
    for tests, gets the driver after its set-up; `control` adds the
    control's readings (the reference in TF32 in the program's place) as
    ``_control``."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    spec = spec or load_spec(cell)
    dev = torch.device(device)
    set_tf32(torch, False)
    cuda = dev.type == "cuda"
    if cuda:
        from imageanalysis3_tpu_torch import _build
        torch.cuda.init()
        t_build = _build.build(spec.config["kernels"])
    ctx = Context(spec, seed, dev, torch, trace, t0)
    drv = driver_class(spec.traffic["driver"])(ctx)
    drv.setup()
    if driver_hook is not None:
        driver_hook(drv)
    if trace and cuda:
        # the profiler's first start (CUPTI) belongs to set-up
        from .trace import capture
        capture(torch, lambda: torch.ones(1, device=dev).add_(1), {})
    ctx.sync()
    t_w0 = time.perf_counter()
    age = process_age()
    setup_s = age if age is not None else t_w0 - t0

    lats, units, summary = [], 0, None
    k_trace = int(spec.traffic["trace_units"])
    n_fit = len(spec.config["fit_channels"])
    while True:
        if trace and cuda and summary is None and units >= 1:
            from .trace import capture
            per = drv.rounds_per_unit
            summary = capture(
                torch, lambda: [lats.extend(drv.unit())
                                for _ in range(k_trace)],
                {"units": k_trace, "rounds": k_trace * per,
                 "fits": k_trace * per * n_fit})
            units += k_trace
        else:
            lats.extend(drv.unit())
            units += 1
        t_end = time.perf_counter()
        if t_end - t_w0 >= seconds and (summary is not None or not trace
                                        or not cuda):
            break
    n_rounds = len(lats)
    ms = [1e3 * v for v in lats]
    mem = torch.cuda.max_memory_allocated(dev) if cuda else 0
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    summary_line = {
        "rounds": n_rounds, "units": units, "window_s": t_end - t_w0,
        "round_p50_ms": statistics.median(ms),
        "round_p95_ms": timeline.percentile(ms, 95),
        "round_max_ms": max(ms), "memory_peak_bytes": mem,
        "setup_s": setup_s, "setup_phases_s": ctx.phases}
    if cuda:
        summary_line["kernel_build_s"] = t_build

    stages: Dict[str, list] = {}
    metrics: Dict[str, dict] = {}
    if not trace:
        values = {"rounds_per_s": timeline.rate(n_rounds, t_w0, t_end),
                  "round_p95_ms": timeline.percentile(ms, 95),
                  "setup_s": setup_s}
        for m in spec.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        stages = drv.split()
        rec = RunRecord(spec, summary, stages, peaks(kind))
        for m in spec.per_layer:
            v = metric_reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    drv.release()
    numbers = drv.check()
    limits = spec.checks["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    out = {"correct": correct, "attempted": n_rounds,
           "failed": min(drv.failed_rounds, n_rounds), "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                      "count": 1, "memory_peak_bytes": int(mem)}}
    if trace and summary is not None:
        out["device"]["busy_s"] = summary.busy_s
        out["device"]["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": summary.device_ops,
                            "idle_gaps": summary.idle_gaps}
    out["checks"] = checks
    if control:
        out["_control"] = drv.control()
    out["_numbers"] = numbers
    out["_summary"] = summary_line
    out["_stages"] = {k: statistics.median(v) for k, v in stages.items() if v}
    return out


def main(args, t0: float) -> int:
    import torch

    spec = load_spec(args.workload)
    need = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: the cell needs {need} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    try:
        import imageanalysis3_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program is not in this checkout ({e})",
              file=sys.stderr)
        return 3
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   spec=spec, t0=t0)
    # after the run: nvidia-smi is no part of the set-up
    print(f"portbench: {args.workload} seed {args.seed} seconds "
          f"{args.seconds} trace {args.trace}; card {card_line()}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process holds {bad} after the window",
              file=sys.stderr)
        return 4
    out.pop("_numbers")
    print("portbench summary: " + json.dumps(out.pop("_summary")), flush=True)
    print("portbench stages (median s): " + json.dumps(out.pop("_stages")),
          flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
