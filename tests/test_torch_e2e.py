"""PyTorch port vs JAX package: the end-to-end path on the CPU.

A small bench_e2e.py-style scene (6 rounds x 2 data channels + a bead
channel, a pair-unique 3-on-bit codebook over 12 bits, 2 chromosomes x 5
regions x 2 homologs, distractors and integer drifts), rendered once by the
port and handed to both packages as NumPy: the JAX ``FovPipeline`` and
``DNAMerfishDecoder`` against the port's, whose state is carried across by
``pipeline_from_arrays`` / ``decoder_from_arrays``.  The exact seeding
classifier (``pyramid_bg=False``) runs on both sides.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from imageanalysis3_tpu.config import ExperimentConfig, FitConfig, SeedConfig
from imageanalysis3_tpu.decode.dna_decoder import DNAMerfishDecoder
from imageanalysis3_tpu.pipeline import FovPipeline as JaxPipeline
from imageanalysis3_tpu_torch import synthetic as tsyn
from imageanalysis3_tpu_torch.convert import (decoder_from_arrays,
                                              pipeline_from_arrays)

torch.set_num_threads(2)
SHAPE = (16, 192, 192)
PX = np.array(tsyn.E2E_PIXEL_SIZE_NM)
LAYOUT = tsyn.E2ELayout(center_z=8.0, origin=50.0, pitch=90.0, grid_cols=2,
                        step=(0.5, 5.0, 5.0), z_clip=(5.0, 11.0),
                        xy_clip=(25.0, 167.0), margin_z=4.0, margin_xy=12.0,
                        drift_max=2.0, n_beads=12)
#: fitted centres of the two packages agree within FitConfig.max_dist_th
#: (0.1 px): the Jacobi refit stops once no contested spot moves by more,
#: so a borderline stop can differ between them (isolated spots agree
#: within 1e-3 px, test_torch_pipeline.py)
CENTRE_ATOL_PX = 0.1
#: traces (centroids of 3 member spots) then agree within 0.1 px of the
#: coarsest axis, 0.1 x 200 nm
TRACE_ATOL_NM = 20.0
DECODE_KW = dict(spot_bucket=1024, group_bucket=64)


@pytest.fixture(scope="module")
def e2e():
    scene = tsyn.make_e2e_scene(shape=SHAPE, n_rounds=6, n_data_ch=2,
                                n_chr=2, n_per_chr=5, n_distractors=30,
                                seed=11, layout=LAYOUT)
    raws = [scene.round_stack(r, device="cpu").numpy()
            for r in range(scene.n_rounds)]
    cfg = ExperimentConfig(
        image_size=SHAPE,
        seed=SeedConfig(th_seed=300.0, max_num_seeds=128, pyramid_bg=False),
        fit=FitConfig())
    jp = JaxPipeline(cfg, n_channels=3, drift_channel_index=2,
                     fit_channel_indices=(0, 1), image_shape=SHAPE)
    j_ref = jp.prepare_reference(jp.correct_reference(jnp.asarray(raws[0])))
    arrays = {"image_shape": np.asarray(SHAPE),
              "drift_idx": np.asarray(jp.drift_idx),
              "fit_idx": np.asarray(jp.fit_idx),
              "chromatic": np.asarray(jp.chromatic),
              "chrom_center": np.asarray(jp.chrom_center),
              "seed_thresholds": np.asarray(jp.seed_thresholds),
              "crops": np.asarray(jp.crops),
              "ref_spectra": np.asarray(j_ref)}
    tp, t_ref = pipeline_from_arrays(dataclasses.asdict(cfg), arrays,
                                     device="cpu")
    out = {"scene": scene, "j": {"spots": [], "bits": [], "drift": []},
           "t": {"spots": [], "bits": [], "drift": []}}
    for r, raw in enumerate(raws):
        res_j = jp.process_round(jnp.asarray(raw), j_ref)
        res_t = tp.process_round(torch.from_numpy(raw.astype(np.int32)),
                                 t_ref)
        for side, res in (("j", res_j), ("t", res_t)):
            spots = np.asarray(res.spots)
            valid = np.asarray(res.valid)
            out[side]["drift"].append(np.asarray(res.drift))
            for ci in range(2):
                out[side]["spots"].append(spots[ci][valid[ci]])
                out[side]["bits"].append(np.full(int(valid[ci].sum()),
                                                 2 * r + ci + 1))
    for side in ("j", "t"):
        out[side]["spots"] = np.concatenate(out[side]["spots"]) \
            .astype(np.float32)
        out[side]["bits"] = np.concatenate(out[side]["bits"])
    jdec = DNAMerfishDecoder(pd.DataFrame(scene.codebook),
                             pair_search_radius=250.0, keep_ratio_th=0.2)
    tdec = decoder_from_arrays(
        {"matrix": jdec.codebook.matrix, "ids": jdec.codebook.ids,
         "bit_values": jdec.codebook.bit_values,
         "chr": jdec.codebook_df["chr"].to_numpy(),
         "pixel_sizes": jdec.pixel_sizes},
        pair_search_radius=jdec.decoder.search_th,
        num_homologs=jdec.num_homologs, keep_ratio_th=jdec.keep_ratio_th,
        device="cpu")
    out["j"]["traces"] = jdec.decode(out["j"]["spots"], out["j"]["bits"],
                                     **DECODE_KW)
    out["t"]["traces"] = tdec.decode(out["t"]["spots"], out["t"]["bits"],
                                     **DECODE_KW)
    out["j"]["groups"] = jdec.spot_groups
    out["t"]["groups"] = tdec.spot_groups
    return out


def test_e2e_drifts_match_jax_and_truth(e2e):
    """Per-round drift within one upsample step of JAX's and of the planted
    integer drift."""
    scene = e2e["scene"]
    for r in range(scene.n_rounds):
        np.testing.assert_allclose(e2e["t"]["drift"][r], e2e["j"]["drift"][r],
                                   atol=0.0100001)
        np.testing.assert_allclose(e2e["t"]["drift"][r], -scene.drifts[r],
                                   atol=0.11)


def test_e2e_spot_tables_match_jax(e2e):
    """The same candidate spots per bit, matched one to one by nearest
    centre: >= 98% within CENTRE_ATOL_PX and >= 90% within 1e-3 px.  The
    rest are ill-determined fits of crowded distractors (neighbours within
    ~5 px, where the LM has two optima and f32 rounding picks one)."""
    st, sj = e2e["t"], e2e["j"]
    np.testing.assert_array_equal(st["bits"], sj["bits"])
    err = []
    for b in np.unique(sj["bits"]):
        ct = st["spots"][st["bits"] == b][:, 1:4]
        cj = sj["spots"][sj["bits"] == b][:, 1:4]
        d = np.linalg.norm(ct[:, None] - cj[None], axis=-1)
        match = d.argmin(axis=1)
        assert len(set(match.tolist())) == len(cj)
        err.extend(np.abs(ct - cj[match]).max(axis=1).tolist())
    err = np.asarray(err)
    assert len(err) >= 12 * 30
    assert (err <= CENTRE_ATOL_PX).mean() >= 0.98
    assert (err <= 1e-3).mean() >= 0.9


def test_e2e_decoded_groups_match_jax(e2e):
    """The same decoded tuples (as member-spot positions rounded to the
    voxel) and regions."""

    def tuples(side):
        g, spots = e2e[side]["groups"], e2e[side]["spots"]
        ok = np.asarray(g.ok)
        idx = np.asarray(g.spot_idx)[ok]
        out = []
        for row, reg in zip(idx, np.asarray(g.region)[ok]):
            members = sorted(tuple(np.round(spots[i, 1:4]))
                             for i in row if i >= 0)
            out.append((int(reg), tuple(members)))
        return sorted(out)

    tj, tt = tuples("j"), tuples("t")
    assert [r for r, _ in tt] == [r for r, _ in tj]
    assert len(tj) >= 16
    for (_, mt), (_, mj) in zip(tt, tj):
        np.testing.assert_allclose(np.asarray(mt), np.asarray(mj), atol=1.0)


def test_e2e_traces_match_jax(e2e):
    """Per chromosome: the same selected groups and trace validity, traces
    within TRACE_ATOL_NM."""
    oj, ot = e2e["j"]["traces"], e2e["t"]["traces"]
    assert sorted(ot) == sorted(oj) == ["chr1", "chr2"]
    for c in oj:
        np.testing.assert_array_equal(ot[c].sel_group.numpy(),
                                      np.asarray(oj[c].sel_group))
        np.testing.assert_array_equal(ot[c].zxys_valid.numpy(),
                                      np.asarray(oj[c].zxys_valid))
        np.testing.assert_allclose(ot[c].zxys.numpy(), np.asarray(oj[c].zxys),
                                   atol=TRACE_ATOL_NM, equal_nan=True)


def test_e2e_traces_recover_planted_regions(e2e):
    """The port's traces assign >= 90% of the 20 planted (region, homolog)
    cells, each within 150 nm of its planted position (homolog order
    resolved per chromosome)."""
    scene, out = e2e["scene"], e2e["t"]["traces"]
    errs = []
    for c in range(2):
        res = out[f"chr{c + 1}"]
        z, ok = res.zxys.numpy(), res.zxys_valid.numpy()
        truth = np.stack([scene.truth[(c, h)] * PX for h in range(2)])
        best = min(((np.nansum(np.where(ok, np.linalg.norm(
            z - truth[list(p)], axis=-1), np.nan)), p)
            for p in ((0, 1), (1, 0))), key=lambda t: t[0])
        d = np.linalg.norm(z - truth[list(best[1])], axis=-1)
        errs.extend(d[ok].tolist())
    assert len(errs) >= 18
    assert np.max(errs) < 150.0
