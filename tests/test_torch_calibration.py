"""PyTorch port vs JAX package: the bead-calibration slice as a whole.

One small calibration scene (the port's ``make_calibration_scene``, rendered
on the CPU and handed to both packages as NumPy): each package makes the
illumination, bleedthrough and chromatic profiles; the port's go through
profile files into the port's ``FovPipeline``, the JAX package's straight
into the JAX ``FovPipeline``; both process one 3-channel round rendered under
the same optics.  The round results agree within test_torch_e2e.py's
tolerances, and the port's spots recover the planted ones.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageanalysis3_tpu.config import (CorrectionConfig, ExperimentConfig,
                                       FitConfig, SeedConfig)
from imageanalysis3_tpu.ops import profiles as jp
from imageanalysis3_tpu.pipeline import FovPipeline as JaxPipeline
from imageanalysis3_tpu_torch import synthetic as tsyn
from imageanalysis3_tpu_torch.config import config_from_dict
from imageanalysis3_tpu_torch.io import (load_correction_profile,
                                         save_correction_profile)
from imageanalysis3_tpu_torch.ops import profiles as tp
from imageanalysis3_tpu_torch.pipeline import FovPipeline

torch.set_num_threads(2)
SHAPE = (12, 128, 128)
CHANNELS = ("750", "647", "561")
REF = 1
#: test_torch_e2e.py's tolerances: fitted centres of the two packages agree
#: within FitConfig.max_dist_th (0.1 px), a borderline Jacobi stop apart
CENTRE_ATOL_PX = 0.1
#: and the isolated spots' fits within 1e-3 px
ISOLATED_ATOL_PX = 1e-3
CFG = ExperimentConfig(
    image_size=SHAPE, correction=CorrectionConfig(bleedthrough=True),
    seed=SeedConfig(th_seed=300.0, max_num_seeds=64, pyramid_bg=False),
    fit=FitConfig())


def _calibrate(pkg, scene, stacks, rounds, beads):
    """Illumination, bleed and chromatic profiles of one package ->
    (illumination (C, X, Y), bleed (C, C, X, Y), {channel: (3, 10)},
    {channel: n_pairs})."""
    kw = {} if pkg is jp else {"device": "cpu"}
    prof = pkg.IlluminationProfiler(SHAPE[1:], smooth_sigma=12.0, **kw)
    for s in stacks:
        prof.add_stack(s)
    illum = np.stack([prof.finalize()] * 3)
    bleed = pkg.generate_bleed_profile_from_rounds(rounds, min_spots=5, **kw)
    chrom, n_pairs = {}, {}
    for ci, (tar, ref) in beads.items():
        chrom[CHANNELS[ci]], n_pairs[ci] = pkg.generate_chromatic_constants(
            tar, ref, max_num_seeds=64, **kw)
    return illum, bleed, chrom, n_pairs


@pytest.fixture(scope="module")
def calib(tmp_path_factory):
    scene = tsyn.make_calibration_scene(
        shape=SHAPE, n_illum_spots=6, n_bleed_spots=14, n_beads=30,
        bead_separation=15.0, n_round_spots=10, seed=5)
    f32 = lambda t: t.numpy().astype(np.float32)
    stacks = [f32(scene.illumination_stack(k, device="cpu"))
              for k in range(4)]
    rounds = [f32(scene.bleed_round(i, device="cpu")) for i in range(3)]
    beads = {ci: tuple(f32(t) for t in scene.bead_pair(ci, device="cpu"))
             for ci in (0, 2)}
    raw = scene.round_stack(device="cpu").numpy()
    out = {"scene": scene}
    j_illum, j_bleed, j_chrom, j_pairs = _calibrate(jp, scene, stacks,
                                                    rounds, beads)
    t_illum, t_bleed, t_chrom, t_pairs = _calibrate(tp, scene, stacks,
                                                    rounds, beads)
    out["profiles"] = {"j": (j_illum, j_bleed, j_chrom),
                       "t": (t_illum, t_bleed, t_chrom)}
    out["n_pairs"] = (j_pairs, t_pairs)

    # the port's profiles through files
    folder = str(tmp_path_factory.mktemp("corrections"))
    save_correction_profile("illumination", dict(zip(CHANNELS, t_illum)),
                            folder, CHANNELS, CHANNELS[REF], SHAPE)
    save_correction_profile("bleedthrough", t_bleed, folder, CHANNELS,
                            CHANNELS[REF], SHAPE)
    save_correction_profile("chromatic_constants", t_chrom, folder, CHANNELS,
                            CHANNELS[REF], SHAPE)
    load = lambda kind: load_correction_profile(kind, folder, CHANNELS,
                                                CHANNELS[REF], SHAPE)
    illum_f = load("illumination")
    const_f = load("chromatic_constants")
    tpipe = FovPipeline(
        config_from_dict(dataclasses.asdict(CFG)),
        n_channels=3, drift_channel_index=REF, fit_channel_indices=(0, 1, 2),
        illumination=np.stack([illum_f[c] for c in CHANNELS]),
        bleed=load("bleedthrough"),
        chromatic_constants=np.stack([
            np.zeros((3, 10), np.float32) if const_f[c] is None
            else const_f[c] for c in CHANNELS]),
        image_shape=SHAPE, device="cpu")
    jpipe = JaxPipeline(
        CFG, n_channels=3, drift_channel_index=REF,
        fit_channel_indices=(0, 1, 2), illumination=j_illum, bleed=j_bleed,
        chromatic_constants=np.stack([
            j_chrom.get(c, np.zeros((3, 10), np.float32)) for c in CHANNELS]),
        image_shape=SHAPE)
    t_ref = tpipe.prepare_reference(tpipe.correct_reference(
        torch.from_numpy(raw.astype(np.int32))))
    out["t"] = tpipe.process_round(torch.from_numpy(raw.astype(np.int32)),
                                   t_ref)
    j_ref = jpipe.prepare_reference(jpipe.correct_reference(
        jnp.asarray(raw)))
    out["j"] = jpipe.process_round(jnp.asarray(raw), j_ref)
    return out


def test_profiles_match_jax(calib):
    """The two packages' profiles: illumination within 1e-5 of its maximum,
    the inverse mixing within 1e-4, the chromatic shift fields within 1e-3
    px over the stack, the same bead-pair counts (test_torch_profiles.py's
    tolerances)."""
    (ji, jb, jc), (ti, tb, tc) = (calib["profiles"]["j"],
                                  calib["profiles"]["t"])
    np.testing.assert_allclose(ti, ji, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-4)
    assert calib["n_pairs"][0] == calib["n_pairs"][1]
    assert min(calib["n_pairs"][1].values()) >= 15
    scene = calib["scene"]
    grid = np.stack(np.meshgrid(*[np.linspace(0, s - 1, 6) for s in SHAPE],
                                indexing="ij"), -1).reshape(-1, 3)
    for ch in ("750", "561"):
        fields = [tsyn._poly_shift_np(grid, c[ch], scene.ref_center)
                  for c in (tc, jc)]
        np.testing.assert_allclose(fields[0], fields[1], atol=1e-3)


def test_profiles_recover_the_planted_optics(calib):
    """The port's profiles against the planted optics: the vignette's
    interior within 0.05 mean absolute error (tests/test_profiles.py's
    criterion), the mixing at the FOV centre within 0.01 of the planted
    0.08 leaks, the shift fields within 0.1 px where the beads are (the
    fit's support: z outside the beads' planes is extrapolation)."""
    scene = calib["scene"]
    illum, bleed, chrom = calib["profiles"]["t"]
    sl = slice(16, -16)
    want = scene.illumination[sl, sl] / scene.illumination[sl, sl].max()
    got = illum[0][sl, sl] / illum[0][sl, sl].max()
    assert np.abs(got - want).mean() < 0.05
    mixing = np.linalg.inv(bleed[:, :, SHAPE[1] // 2, SHAPE[2] // 2])
    np.testing.assert_allclose(mixing, scene.mixing, atol=0.01)
    beads = scene.beads["centers"]
    for ci, ch in ((0, "750"), (2, "561")):
        np.testing.assert_allclose(
            tsyn._poly_shift_np(beads, chrom[ch], scene.ref_center),
            scene.shifted(ci, beads) - beads, atol=0.1)


def test_round_results_match_jax(calib):
    """The corrected round: the same drift (0, within one upsample step),
    the same number of valid spots per channel, matched one to one by
    nearest centre: all within CENTRE_ATOL_PX, >= 90% within
    ISOLATED_ATOL_PX."""
    rt, rj = calib["t"], calib["j"]
    np.testing.assert_allclose(rt.drift.numpy(), np.asarray(rj.drift),
                               atol=0.0100001)
    vt, vj = rt.valid.numpy(), np.asarray(rj.valid)
    np.testing.assert_array_equal(vt.sum(1), vj.sum(1))
    err = []
    for ci in range(3):
        ct = rt.spots.numpy()[ci][vt[ci]][:, 1:4]
        cj = np.asarray(rj.spots)[ci][vj[ci]][:, 1:4]
        d = np.linalg.norm(ct[:, None] - cj[None], axis=-1)
        match = d.argmin(axis=1)
        assert len(set(match.tolist())) == len(cj)
        err.extend(np.abs(ct - cj[match]).max(axis=1).tolist())
    err = np.asarray(err)
    assert len(err) >= 27
    assert (err <= CENTRE_ATOL_PX).all()
    assert (err <= ISOLATED_ATOL_PX).mean() >= 0.9


def test_round_recovers_planted_spots(calib):
    """The port's corrected spots against the planted positions: every
    planted spot found within 1 px, median error <= 0.1 px per channel
    (chip_smoke.py's gate at full size)."""
    scene, rt = calib["scene"], calib["t"]
    for ci in range(3):
        got = rt.spots[ci][rt.valid[ci]][:, 1:4].numpy()
        truth = scene.round_spots[ci]["centers"]
        d = np.linalg.norm(truth[:, None] - got[None], axis=-1).min(axis=1)
        assert (d < 1.0).all(), d
        assert np.median(d) <= 0.1, np.median(d)
