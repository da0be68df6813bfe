"""The plain reference against the port on a tiny CPU scene, each stage
apart; the comparison's numbers; the frozen spot sampler."""

import numpy as np
import pytest
import torch

from conftest import tiny_spec
from portbench.harness.cell import (Context, make_scene, scene_optics,
                                    seed_thresholds)
from portbench.harness import compare

SEED = 4242


def _pipeline(spec, scene):
    from imageanalysis3_tpu_torch.config import config_from_dict
    from imageanalysis3_tpu_torch.pipeline import FovPipeline

    c = spec.config
    illum, chrom = scene_optics(scene)
    return FovPipeline(config_from_dict(dict(c["pipeline"],
                                             image_size=c["shape"])),
                       n_channels=c["n_channels"],
                       drift_channel_index=c["drift_channel"],
                       fit_channel_indices=tuple(c["fit_channels"]),
                       illumination=illum, chromatic_constants=chrom,
                       image_shape=tuple(c["shape"]),
                       seed_thresholds=seed_thresholds(c), device="cpu")


def _reference(spec, scene):
    from portbench.reference.round import ReferenceRound

    c = spec.config
    illum, chrom = scene_optics(scene)
    return ReferenceRound(c["pipeline"], c["shape"], c["drift_channel"],
                          c["fit_channels"], illum, chrom, seed_thresholds(c),
                          "cpu")


def test_round_stages_equal_the_port():
    spec = tiny_spec("seq_tracing.rounds")
    scene = make_scene(Context(spec, SEED, torch.device("cpu"), torch, False))
    pipe, rr = _pipeline(spec, scene), _reference(spec, scene)
    ref_raw, raw = scene.round_stack(-1, "cpu"), scene.round_stack(0, "cpu")
    for ci in range(3):
        assert torch.equal(pipe.correct_one(raw[ci], ci), rr.correct(raw[ci],
                                                                    ci))
    spectra = rr.spectra(ref_raw)
    assert torch.equal(
        pipe.prepare_reference(pipe.correct_reference(ref_raw)), spectra)
    res, ro = pipe.process_round(raw, spectra), rr.run(raw, spectra)
    assert torch.equal(res.drift, ro.drift)
    assert torch.equal(res.valid, ro.valid)
    assert torch.equal(res.spots[res.valid], ro.spots[ro.valid])
    # the planted scene is found: drift against the planted one, spots
    assert np.abs(res.drift.numpy() + scene.drift(0)).max() < 0.1
    assert int(res.valid[0].sum()) >= 30


def test_spot_table_numbers():
    a = np.zeros((1, 4, 11))
    a[0, :, 1:4] = [[1, 1, 1], [5, 5, 5], [9, 9, 9], [20, 20, 20]]
    a[0, :, 0] = 100.0
    va = np.array([[True, True, True, False]])
    b = a.copy()
    b[0, 1, 2] += 0.25
    b[0, 2, 0] = 110.0
    s = compare.spot_tables(a, va, b, va)
    assert s == {"unpaired": 0, "moved": 2, "n_ref": 3, "spot_gap_px": 0.25,
                 "height_gap": 10.0 / 110.0}
    vb = np.array([[True, True, False, True]])
    s = compare.spot_tables(a, va, b, vb)
    assert s["unpaired"] == 2 and s["moved"] == 3 and s["n_ref"] == 3


def _sample_loop(shape, n_spots, rng, min_separation, edge_margin=8.0):
    """The sampler as a one-trial-at-a-time loop (synthetic.py's form)."""
    margin = np.minimum(np.full(3, edge_margin), np.array(shape) / 3.0)
    lo, hi = margin, np.array(shape) - margin
    centers, trials = [], 0
    while len(centers) < n_spots and trials < n_spots * 200:
        trials += 1
        c = rng.uniform(lo, hi)
        if min_separation > 0 and centers:
            if np.linalg.norm(np.array(centers) - c, axis=1).min() \
                    < min_separation:
                continue
        centers.append(c)
    return np.array(centers)


@pytest.mark.parametrize("shape, n, sep", [((60, 512, 512), 300, 8.0),
                                           ((16, 128, 128), 40, 14.0),
                                           ((12, 64, 64), 60, 14.0),
                                           ((60, 512, 512), 100, 0.0)])
def test_block_sampler_draws_as_the_loop(shape, n, sep):
    from portbench.harness.scene import rng_of, sample_spot_params

    for seed in (3, 2 ** 31 + 3):
        a_rng, b_rng = rng_of(seed, 1), rng_of(seed, 1)
        got = sample_spot_params(shape, n, a_rng, min_separation=sep)
        want = _sample_loop(shape, n, b_rng, sep)
        assert np.array_equal(got["centers"], want)
        # the generator is left where the loop leaves it
        assert np.array_equal(got["heights"], b_rng.uniform(300.0, 3000.0,
                                                            len(want)))
