"""Each kernel's least time at chip_smoke.py's bench shapes against its
bounds for the same shapes (PERF.md's kernel table, 3.35 TB/s and 67
TFLOP/s f32), and at the configurations' own shapes."""

import copy

import pytest

from portbench.harness.peaks import function_name, peaks
from portbench.harness.spec import load_spec
from portbench.roofline import lm_fit, seed_pyramid

SXM = peaks("NVIDIA H100 80GB HBM3")


def at(cell, planes, seeds):
    """The cell's configuration at another plane count and seed capacity."""
    cfg = copy.deepcopy(load_spec(cell).config)
    cfg["shape"][0] = planes
    cfg["pipeline"]["seed"]["max_num_seeds"] = seeds
    return cfg


def test_peaks_are_the_published_ones():
    assert SXM[:2] == (3.35e12, 67.0e12)
    assert peaks("NVIDIA H100 PCIe")[:2] == (2.0e12, 51.2e12)


def test_seed_pyramid_at_the_seq_tracing_shape():
    t, by = seed_pyramid.least(at("seq_tracing.rounds", 60, 2048), SXM)
    assert by == "bytes"
    assert 1e3 * t == pytest.approx(0.620, abs=5e-4)
    # the configuration's 30 planes: half the bytes
    t30, _ = seed_pyramid.least(load_spec("seq_tracing.rounds").config, SXM)
    assert t30 == pytest.approx(t / 2, rel=1e-6)


@pytest.mark.parametrize("seeds, first_ms, refit_ms", [
    (2048, 0.0357, 0.0089), (4096, 0.0713, 0.0178)])
def test_lm_fit_launch_shapes(seeds, first_ms, refit_ms):
    cfg = at("seq_tracing.rounds", 60, seeds)
    first, refit = lm_fit.shapes(cfg)
    assert first[1] == refit[1] == 512
    assert 1e3 * lm_fit.least_of(*first, SXM)[0] == pytest.approx(
        first_ms, abs=5e-5)
    assert 1e3 * lm_fit.least_of(*refit, SXM)[0] == pytest.approx(
        refit_ms, abs=5e-5)
    # three fits, two refit launches besides: the sum of the shapes
    assert 1e3 * lm_fit.least(cfg, SXM, 3, 5) == pytest.approx(
        3 * first_ms + 2 * refit_ms, abs=3e-4)


@pytest.mark.parametrize("name, want", [
    ("void (anonymous namespace)::lm_fit_kernel<4>(float const*, float*)",
     "lm_fit_kernel<4>"),
    ("seed_pyramid_kernel(Args)", "seed_pyramid_kernel"),
    ("_ZN12_GLOBAL__N_120seed_classify_kernelE4Args",
     "seed_classify_kernel"),
    ("Memcpy HtoD (Pinned -> Device)", "Memcpy HtoD (Pinned -> Device)")])
def test_kernel_names_from_the_profiler(name, want):
    assert function_name(name) == want
