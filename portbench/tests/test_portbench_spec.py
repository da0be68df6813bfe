"""A new configuration, traffic mix, cell and per-layer metric need only
new files and new entries in BENCHMARK.json: a throwaway set added to a
copy of the benchmark is found by name and runs."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.harness.spec import load_spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.parametrize("cell", ["seq_tracing.rounds",
                                  "seq_tracing.raw_host"])
def test_every_cell_loads(cell):
    s = load_spec(cell)
    assert s.config["shape"] == [30, 2048, 2048]
    assert {m["name"] for m in s.end_to_end} == {
        "rounds_per_s", "round_p95_ms", "setup_s"}
    assert set(s.checks["limits"]) >= {"drift_gap_px", "moved_share"}
    for m in s.per_layer:
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                           m["name"] + ".py"))


PROBE = '''"""probe: a throwaway metric."""


def read(run):
    return 1e3 * len(run.stages["fit"])
'''


def test_new_cell_config_mix_and_metric_are_new_files(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    pb = tmp_path / "portbench"
    cfg = json.load(open(pb / "configs" / "seq_tracing.json"))
    cfg["shape"] = [16, 128, 128]
    cfg["scene"].update(spots_per_channel=40, beads=40)
    cfg["pipeline"]["seed"]["max_num_seeds"] = 64
    cfg["pipeline"]["drift"]["drift_size"] = 64
    json.dump(cfg, open(pb / "configs" / "probe_cfg.json", "w"))
    json.dump({"driver": "resident_rounds", "pool_rounds": 2,
               "warm_units": 1, "trace_units": 1},
              open(pb / "traffic" / "probe_mix.json", "w"))
    json.dump({"check_rounds": 2, "limits": {"spot_gap_px": 0.0}},
              open(pb / "workloads" / "probe_cfg.probe_mix.json", "w"))
    (pb / "metrics" / "probe_metric.py").write_text(PROBE)
    bench["configs"].append({"name": "probe_cfg", "source": "a test",
                             "file": "portbench/configs/probe_cfg.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "probe_cfg.probe_mix",
                               "config": "probe_cfg", "traffic": "probe_mix",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "probe_metric", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "probe", "moves": "rounds_per_s",
                               "workloads": ["probe_cfg.probe_mix"]})
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    code = ("import json, sys; sys.path.insert(0, %r); sys.path.append(%r)\n"
            "from portbench.harness.bench import run_cell\n"
            "out = run_cell('probe_cfg.probe_mix', 5, 0.0, True, "
            "device='cpu')\n"
            "print(json.dumps({k: out[k] for k in ('correct', 'metrics')}))"
            % (str(tmp_path), ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    # two pool rounds timed apart, two data channels each
    assert out["metrics"]["probe_metric"]["value"] == 4000.0
    # a metric whose `workloads` leaves the cell out is not read there
    assert set(out["metrics"]) == {"probe_metric"}
