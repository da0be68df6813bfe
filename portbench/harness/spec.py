"""Everything of one cell, found by name.

``BENCHMARK.json`` at the checkout's root names the cell's configuration
and traffic mix and lists the metrics; the files live under ``portbench/``:

- ``configs/<config>.json``: the deployment (shapes, channels, optics,
  seeding and fit settings, the scene's parameters);
- ``traffic/<traffic>.json``: the mix's parameters and the name of the
  driver that runs its loop, ``drivers/<driver>.py``;
- ``workloads/<cell>.json``: how many of the window's answers the
  reference checks, and the limit of each number compared;
- ``metrics/<metric>.py``: the reader of one per-layer metric;
- ``roofline/<kernel>.py``: a kernel's bytes and operations.

A new cell, configuration, mix or metric is new files and new entries in
``BENCHMARK.json``; nothing here changes.
"""

from __future__ import annotations

import importlib
import json
import os
from dataclasses import dataclass
from typing import Callable, List

#: the checkout's root: the directory that holds portbench/
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PACKAGE = os.path.basename(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Spec:
    name: str
    cell: dict          # the BENCHMARK.json entry
    config: dict
    traffic: dict
    checks: dict        # workloads/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_spec(cell: str, root: str = ROOT) -> Spec:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json "
                       f"(cells: {sorted(cells)})")
    entry = cells[cell]
    configs = {c["name"]: c for c in bench["configs"]}
    here = os.path.join(root, PACKAGE)
    return Spec(
        name=cell, cell=entry,
        config=_json(os.path.join(root, configs[entry["config"]]["file"])),
        traffic=_json(os.path.join(here, "traffic",
                                   entry["traffic"] + ".json")),
        checks=_json(os.path.join(here, "workloads", cell + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, cell)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, cell)])


def driver_class(name: str):
    return importlib.import_module(f"{PACKAGE}.drivers.{name}").Driver


def metric_reader(name: str) -> Callable:
    return importlib.import_module(f"{PACKAGE}.metrics.{name}").read


def roofline(kernel: str):
    return importlib.import_module(f"{PACKAGE}.roofline.{kernel}")
