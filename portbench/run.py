#!/usr/bin/env python3
"""Benchmark of imageanalysis3_tpu_torch on one CUDA card: one cell, once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up the cell named in BENCHMARK.json (inputs rendered on the card from
the seed, the program built and warmed), measures for the window, and
prints one JSON line last: ``correct``, ``attempted``, ``failed``,
``metrics`` (the end-to-end metrics with ``--trace 0``, the per-layer ones
with ``--trace 1``), ``device``, ``breakdown`` (traced runs) and
``checks`` (each number compared with the plain reference, beside its
limit).  Without a CUDA card it exits non-zero and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build cache of the program inside the checkout, at fixed paths
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    sys.path.insert(0, ROOT)
    from portbench.harness import bench
    return bench.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())
