"""Nothing of the benchmark imports JAX or the JAX package, compared by
whole top-level module name (the port's name begins with the JAX
package's); the reference imports nothing of the port either."""

import ast
import os

import pytest

from portbench.harness.bench import FORBIDDEN, forbidden_modules

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(HERE)
               for f in fs if f.endswith(".py"))
PORT = "imageanalysis3_tpu_torch"


def _imports(path):
    """Top-level names of every module the file imports, relative imports
    left out."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    bad = [m for m in _imports(path) if m in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", [f for f in FILES if os.sep + "reference"
                                  + os.sep in f],
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in set(_imports(path))


def test_whole_name_comparison(monkeypatch):
    import types
    import sys

    monkeypatch.setitem(sys.modules, "imageanalysis3_tpu_torch_probe",
                        types.ModuleType("x"))
    assert "imageanalysis3_tpu_torch_probe" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "imageanalysis3_tpu.probe",
                        types.ModuleType("x"))
    assert "imageanalysis3_tpu.probe" in forbidden_modules()


def test_no_card_exits_nonzero(tmp_path):
    """Without a CUDA card (or with a card count short of the cell's) the
    command prints no result and exits non-zero."""
    import subprocess
    import sys

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         "seq_tracing.rounds", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
