"""PyTorch port vs JAX package: one FOV round end to end on the CPU, and the
port's package boundary (no JAX imports, the CUDA default device)."""

import ast
import dataclasses
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageanalysis3_tpu import synthetic as jsyn
from imageanalysis3_tpu.config import (ExperimentConfig, FitConfig,
                                       SeedConfig)
from imageanalysis3_tpu.pipeline import FovPipeline as JaxPipeline
from imageanalysis3_tpu_torch.config import ExperimentConfig as PortConfig
from imageanalysis3_tpu_torch.convert import pipeline_from_arrays
from imageanalysis3_tpu_torch.pipeline import FovPipeline

torch.set_num_threads(2)
SHAPE = (12, 128, 128)
PORT = pathlib.Path(__file__).resolve().parent.parent / \
    "imageanalysis3_tpu_torch"


def _scene():
    """Two rounds x 2 channels (channel 1 drives registration), vignetting
    and camera noise from seeded NumPy; round 1 is drifted."""
    fov = jsyn.make_synthetic_fov(shape=SHAPE, n_rounds=2, n_channels=2,
                                  n_spots=14, seed=3, drift_scale=2.0)
    ims = np.clip(fov.ims, 0, 65535).astype(np.uint16)
    chrom = np.zeros((2, 3, 10), np.float32)
    chrom[0, :, 0] = [0.1, -0.2, 0.15]
    chrom[0, 1, 2] = 1e-3
    return ims, fov.illumination.astype(np.float32), chrom


def _run_both(pyramid_bg):
    ims, illum, chrom = _scene()
    cfg = ExperimentConfig(
        image_size=SHAPE,
        seed=SeedConfig(th_seed=300.0, max_num_seeds=48,
                        pyramid_bg=pyramid_bg),
        fit=FitConfig())
    jp = JaxPipeline(cfg, n_channels=2, drift_channel_index=1,
                     fit_channel_indices=(0, 1), illumination=illum,
                     chromatic_constants=chrom, image_shape=SHAPE)
    ref = jp.prepare_reference(jp.correct_reference(jnp.asarray(ims[0])))
    want = jp.process_round(jnp.asarray(ims[1]), ref)
    arrays = {"image_shape": np.asarray(SHAPE),
              "drift_idx": np.asarray(jp.drift_idx),
              "fit_idx": np.asarray(jp.fit_idx),
              "illumination": np.asarray(jp.illumination),
              "chromatic": np.asarray(jp.chromatic),
              "chrom_center": np.asarray(jp.chrom_center),
              "seed_thresholds": np.asarray(jp.seed_thresholds),
              "crops": np.asarray(jp.crops),
              "ref_spectra": np.asarray(ref)}
    tp, t_ref = pipeline_from_arrays(dataclasses.asdict(cfg), arrays,
                                     device="cpu")
    got = tp.process_round(torch.from_numpy(ims[1].astype(np.int32)), t_ref)
    return got, want, tp, ims


@pytest.fixture(scope="module")
def exact_round():
    return _run_both(pyramid_bg=False)


def test_round_matches_jax_exact_classifier(exact_round):
    """pyramid_bg=False: the same classifier on both sides -- drift within
    one upsample step, identical valid masks, fits within the
    tests/test_pallas.py tolerances."""
    got, want, _, _ = exact_round
    np.testing.assert_allclose(got.drift.numpy(), np.asarray(want.drift),
                               atol=0.0100001)
    assert int(got.drift_flag) == int(want.drift_flag)
    vj = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), vj)
    assert vj.sum() >= 20
    for name in ("spots", "raw_spots"):
        g = getattr(got, name).numpy()[vj]
        w = np.asarray(getattr(want, name))[vj]
        np.testing.assert_allclose(g[:, 1:4], w[:, 1:4], atol=1e-3)
        np.testing.assert_allclose(g[:, 0], w[:, 0], rtol=1e-2)
        np.testing.assert_allclose(g[:, 5:8], w[:, 5:8], atol=1e-3)


def test_round_matches_jax_default_pyramid():
    """Default config: the port runs the pyramid classifier (plain version
    on the CPU), JAX on the CPU the exact one -- the same valid spots and
    centres."""
    got, want, _, _ = _run_both(pyramid_bg=True)
    for c in range(2):
        v_t = got.valid[c].numpy()
        v_j = np.asarray(want.valid[c])
        c_t = got.spots[c].numpy()[v_t][:, 1:4]
        c_j = np.asarray(want.spots[c])[v_j][:, 1:4]
        assert len(c_t) == len(c_j) > 0
        order_t = np.lexsort(np.round(c_t, 1).T[::-1])
        order_j = np.lexsort(np.round(c_j, 1).T[::-1])
        np.testing.assert_allclose(c_t[order_t], c_j[order_j], atol=1e-3)


def test_returning_ref_matches_reference_correction(exact_round):
    _, _, tp, ims = exact_round
    res, corr = tp.process_round_returning_ref(
        torch.from_numpy(ims[0].astype(np.int32)),
        tp.prepare_reference(tp.correct_reference(
            torch.from_numpy(ims[0].astype(np.int32)))))
    ref = tp.correct_reference(torch.from_numpy(ims[0].astype(np.int32)))
    torch.testing.assert_close(corr, ref, rtol=0, atol=0)
    np.testing.assert_allclose(res.drift.numpy(), 0.0, atol=0.0100001)


def test_warp_spot_coords_matches_jax():
    from imageanalysis3_tpu.ops import warp as jw
    from imageanalysis3_tpu_torch.ops import warp as tw
    rng = np.random.default_rng(6)
    coords = rng.uniform(0, 128, (20, 3)).astype(np.float32)
    const = rng.normal(0, 1e-3, (3, 10)).astype(np.float32)
    const[:, 0] = [0.2, -0.4, 0.1]
    center = np.array([6, 64, 64], np.float32)
    drift = np.array([0.3, -1.2, 2.5], np.float32)
    assert tw.monomial_exponents(3, 2) == jw.monomial_exponents(3, 2)
    want = np.asarray(jw.warp_spot_coords(*map(jnp.asarray, (
        coords, const, center, drift))))
    got = tw.warp_spot_coords(*map(torch.from_numpy, (
        coords, const, center, drift))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def test_synthetic_scene_matches_jax():
    """Same truth draws; the splat+blur render agrees with JAX's device
    render (noise bits differ by design and are not compared)."""
    from imageanalysis3_tpu_torch import synthetic as tsyn
    kw = dict(min_separation=8.0, height_range=(400.0, 3000.0),
              sigma_jitter=0.0)
    tj = jsyn.sample_spot_params(SHAPE, 20, np.random.default_rng(0), **kw)
    tt = tsyn.sample_spot_params(SHAPE, 20, np.random.default_rng(0), **kw)
    for key in ("centers", "heights", "sigmas"):
        np.testing.assert_array_equal(tt[key], tj[key])
    want = np.asarray(jsyn.render_spots_device(SHAPE, tj["centers"],
                                               tj["heights"]))
    got = tsyn.render_spots(SHAPE, tt["centers"], tt["heights"],
                            device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-2)
    noisy = tsyn.noisy_uint16(torch.from_numpy(got), seed=1)
    assert noisy.dtype == torch.uint16 and noisy.shape == SHAPE


def _imports_run_at_import(tree: ast.AST, module: str):
    """The imports of `module` that run when the file is imported: those
    outside every function body."""
    found = []

    def visit(node, in_def):
        for child in ast.iter_child_nodes(node):
            if not in_def and isinstance(child, ast.Import):
                found.extend(a.name for a in child.names
                             if a.name.split(".")[0] == module)
            elif not in_def and isinstance(child, ast.ImportFrom):
                if (child.module or "").split(".")[0] == module:
                    found.append(child.module)
            visit(child, in_def or isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)))

    visit(tree, False)
    return found


def test_port_sources_import_no_jax():
    """No source of the port, nor chip_smoke.py, imports JAX or the JAX
    package anywhere; pandas (which the H100 machine lacks, as it lacks
    JAX) only inside the functions that build DataFrames, never when a
    module is imported."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|imageanalysis3_tpu)"
                     r"(\s|\.|$)", re.M)
    files = list(PORT.rglob("*.py")) + [PORT.parent / "chip_smoke.py"]
    assert len(files) >= 18
    for f in files:
        src = f.read_text()
        assert not pat.search(src), f
        for lib in ("pandas", "matplotlib"):
            assert not _imports_run_at_import(ast.parse(src), lib), (f, lib)
    # the check finds a module-level import, and one in a class body
    assert _imports_run_at_import(ast.parse(
        "import pandas as pd\nclass A:\n    from pandas import x\n"
        "def f():\n    import pandas\n"), "pandas") == ["pandas", "pandas"]


def test_port_imports_without_jax_in_subprocess():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['imageanalysis3_tpu'] = None\n"
        "sys.modules['pandas'] = None\n"
        "import imageanalysis3_tpu_torch\n"
        "from imageanalysis3_tpu_torch import convert, synthetic, _build\n"
        "from imageanalysis3_tpu_torch.ops import (corrections, drift, "
        "filters, gaussian_fit, lm_kernel, seed_kernels, seeding, warp)\n"
        "from imageanalysis3_tpu_torch.decode import (dna_decoder, homolog, "
        "merfish, new_decoder)\n"
        "from imageanalysis3_tpu_torch import library, parallel\n"
        "from imageanalysis3_tpu_torch.parallel import spatial\n"
        "sys.modules['matplotlib'] = None\n"
        "from imageanalysis3_tpu_torch import figures, legacy\n"
        "from imageanalysis3_tpu_torch.figures import interactive\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'imageanalysis3_tpu', 'pandas', 'matplotlib') "
        "and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=PORT.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


#: every subpackage the port has ported, and the modules whose JAX names
#: differed (synthetic's device renderers, gaussian_fit's single-spot fit)
PORTED = ["", "analysis", "decode", "io", "ops", "pipeline", "segmentation",
          "parallel", "library", "figures"]
RENAMED = ["synthetic", "ops.gaussian_fit"]


@pytest.mark.parametrize("sub", PORTED + RENAMED)
def test_package_exports_every_jax_name(sub):
    """Every name the JAX package exports, at the top level and in each
    ported subpackage (its ``__all__``), or defines publicly in a module
    whose names the port had renamed, exists in the port."""
    import importlib
    import inspect
    name = "." + sub if sub else ""
    jax_mod = importlib.import_module("imageanalysis3_tpu" + name)
    port_mod = importlib.import_module("imageanalysis3_tpu_torch" + name)
    if sub in PORTED:
        want = set(jax_mod.__all__)
        assert want <= set(port_mod.__all__)
    else:
        want = {n for n, v in vars(jax_mod).items()
                if not n.startswith("_") and inspect.isfunction(v)
                and v.__module__ == jax_mod.__name__}
    missing = sorted(n for n in want if not hasattr(port_mod, n))
    assert not missing, missing
    if sub == "":
        assert port_mod.__version__ == jax_mod.__version__
        for c in ("DEFAULT_PIXEL_SIZE_NM", "DEFAULT_SIGMA_ZXY",
                  "DEFAULT_IMAGE_SIZE", "ALLOWED_COLORS", "CORR_CHANNELS"):
            assert getattr(port_mod, c) == getattr(jax_mod, c), c


def test_legacy_exports_every_jax_name():
    """legacy.py has no ``__all__``: every public class and function the
    JAX module defines, and every method of its two classes, exists in
    the port's."""
    import inspect
    from imageanalysis3_tpu import legacy as jax_mod
    from imageanalysis3_tpu_torch import legacy as port_mod
    want = {n for n, v in vars(jax_mod).items()
            if not n.startswith("__") and (inspect.isfunction(v)
                                           or inspect.isclass(v))
            and v.__module__ == jax_mod.__name__}
    assert {"CellData", "CellList", "_border_aware_centers"} <= want
    assert not sorted(n for n in want if not hasattr(port_mod, n))
    for cls in ("CellData", "CellList"):
        methods = {n for n, v in vars(getattr(jax_mod, cls)).items()
                   if callable(v) or isinstance(v, (staticmethod,
                                                    classmethod))}
        missing = sorted(n for n in methods
                         if not hasattr(getattr(port_mod, cls), n))
        assert not missing, (cls, missing)


def test_package_data_lists_every_runtime_source():
    """A wheel of the tree carries every non-Python source the port opens
    at run time: the CUDA kernels and both native host libraries match the
    port's package-data globs (and the JAX package's entry is as it was)."""
    import fnmatch
    import tomllib
    cfg = tomllib.loads((PORT.parent / "pyproject.toml").read_text())
    data = cfg["tool"]["setuptools"]["package-data"]
    globs = data["imageanalysis3_tpu_torch"]
    sources = sorted(
        str(f.relative_to(PORT)) for f in PORT.rglob("*")
        if f.is_file() and f.suffix in (".cu", ".cuh", ".cpp", ".c", ".h")
        and "__pycache__" not in f.parts)
    unshipped = [s for s in sources
                 if not any(fnmatch.fnmatch(s, g) for g in globs)]
    assert not unshipped, unshipped
    assert "io/native/daxload.cpp" in sources
    assert "library/native/seqint.cpp" in sources
    assert len([s for s in sources if s.startswith("csrc/")]) >= 8
    assert set(data) == {"imageanalysis3_tpu_torch"}


def test_pipeline_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PortConfig(image_size=SHAPE)
    with pytest.raises(RuntimeError, match="CUDA"):
        FovPipeline(cfg, 1, 0, (0,), image_shape=SHAPE)
    with pytest.raises(RuntimeError, match="CUDA"):
        FovPipeline(cfg, 1, 0, (0,), image_shape=SHAPE, device="cuda")
    assert FovPipeline(cfg, 1, 0, (0,), image_shape=SHAPE,
                       device="cpu").device.type == "cpu"


def test_fit_channel_passes_the_seed_config_as_the_reference(monkeypatch):
    """FovPipeline hands get_seeds SeedConfig.cand_capacity, as the JAX
    package's FovPipeline does."""
    from imageanalysis3_tpu_torch.config import SeedConfig as PortSeed
    from imageanalysis3_tpu_torch.pipeline import fov

    class Stop(Exception):
        pass

    seen = {}

    def spy(im, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(fov, "get_seeds", spy)
    cfg = PortConfig(image_size=SHAPE, seed=PortSeed(cand_capacity=777))
    pipe = FovPipeline(cfg, 1, 0, (0,), image_shape=SHAPE, device="cpu")
    with pytest.raises(Stop):
        pipe.fit_channel(torch.zeros(SHAPE), 300.0)
    assert seen["cand_capacity"] == 777
    assert seen["pyramid_bg"] == cfg.seed.pyramid_bg
