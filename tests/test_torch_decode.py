"""PyTorch port vs JAX package: MERFISH decoding and homolog assignment on
the CPU, on seeded candidate tables (a pair-unique codebook, jittered
region spots and uniform distractors made with NumPy)."""

import numpy as np
import pandas as pd
import pytest
import torch
import jax.numpy as jnp

from imageanalysis3_tpu.decode import dna_decoder as jdna
from imageanalysis3_tpu.decode import homolog as jh
from imageanalysis3_tpu.decode import merfish as jm
from imageanalysis3_tpu.decode.new_decoder import (
    codebook_dataframe_to_tables as j_tables)
from imageanalysis3_tpu_torch import synthetic as tsyn
from imageanalysis3_tpu_torch.convert import decoder_from_arrays
from imageanalysis3_tpu_torch.decode import homolog as th
from imageanalysis3_tpu_torch.decode import merfish as tm
from imageanalysis3_tpu_torch.decode.new_decoder import (
    codebook_dataframe_to_tables as t_tables)

torch.set_num_threads(2)
PX = np.array([200.0, 108.0, 108.0], np.float32)
LAYOUT = tsyn.E2ELayout(center_z=20.0, origin=100.0, pitch=160.0,
                        grid_cols=2, z_clip=(8.0, 32.0),
                        xy_clip=(30.0, 370.0))


def _table(seed=0, n_distractors=60):
    """Candidate rows (N, 11) and 1-based bit labels of a 2-chromosome x 8
    region x 2 homolog scene over 16 bits, plus its codebook columns."""
    scene = tsyn.make_e2e_scene(shape=(40, 400, 400), n_rounds=8,
                                n_data_ch=2, n_chr=2, n_per_chr=8,
                                n_distractors=n_distractors, seed=seed,
                                layout=LAYOUT)
    rng = np.random.default_rng(seed + 100)
    rows, bits = [], []
    for r in range(scene.n_rounds):
        for ci in range(scene.n_data_ch):
            b = r * scene.n_data_ch + ci
            pts = np.vstack([scene.bit_spots[b], scene.distractors[(r, ci)]])
            sp = np.zeros((len(pts), 11), np.float32)
            sp[:, 0] = rng.uniform(500, 3000, len(pts))
            sp[:, 1:4] = pts
            sp[:, 5:8] = 1.5
            rows.append(sp)
            bits.append(np.full(len(pts), b + 1))
    return np.concatenate(rows), np.concatenate(bits), scene


def _positions(spots):
    return spots[:, 1:4] * PX


def test_codebook_tables_match_jax():
    _, _, scene = _table()
    cb_j, _ = j_tables(pd.DataFrame(scene.codebook))
    cb_t, meta = t_tables(scene.codebook)
    for field in ("matrix", "ids", "bit_values", "pair_region"):
        np.testing.assert_array_equal(getattr(cb_t, field),
                                      getattr(cb_j, field))
    assert list(meta) == ["id", "name", "chr"]
    assert cb_t.n_on_bits == 3


def test_find_neighbors_matches_jax():
    """Same neighbours (ascending distance, ties by index) and the same
    in-radius mask, invalid rows and columns excluded."""
    spots, _, _ = _table()
    valid = np.ones(len(spots), bool)
    valid[::17] = False
    pos = _positions(spots)
    idx_j, ok_j = jm.find_neighbors(jnp.asarray(pos), jnp.asarray(valid),
                                    250.0, k=12, block=256)
    idx_t, ok_t = tm.find_neighbors(torch.from_numpy(pos),
                                    torch.from_numpy(valid), 250.0, k=12,
                                    block=256)
    ok_j = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    assert ok_j.sum() >= 100          # ~2 per planted region spot
    # each row's in-radius neighbours; their order can differ where two
    # distances lie within the |a|^2 + |b|^2 - 2ab form's rounding
    nb_j = np.sort(np.where(ok_j, np.asarray(idx_j), -1), axis=1)
    nb_t = np.sort(np.where(ok_j, idx_t.numpy(), -1), axis=1)
    np.testing.assert_array_equal(nb_t, nb_j)


def _pairs_both(spots, bits, cb):
    dec = tm.MerfishDecoder(cb, device="cpu")
    bidx = dec.bit_index_of(bits)
    pos = _positions(spots)
    valid = np.ones(len(spots), bool)
    nb_j = jm.find_neighbors(jnp.asarray(pos), jnp.asarray(valid), 250.0)
    pj = jm.score_pairs(jm.build_pairs(*nb_j, jnp.asarray(bidx),
                                       jnp.asarray(cb.pair_region)),
                        jnp.asarray(spots), jnp.asarray(pos))
    nb_t = tm.find_neighbors(torch.from_numpy(pos), torch.from_numpy(valid),
                             250.0)
    pt = tm.score_pairs(tm.build_pairs(*nb_t, torch.from_numpy(bidx),
                                       torch.from_numpy(cb.pair_region)),
                        torch.from_numpy(spots), torch.from_numpy(pos))
    return pj, pt, nb_j, nb_t, bidx, pos


@pytest.mark.parametrize("seed", [0, 1])
def test_select_pairs_matches_jax(seed):
    """The same pair table, scores within 1e-5, the same greedy selection
    (selected pairs in rank order, usage, counts)."""
    spots, bits, scene = _table(seed)
    cb, _ = t_tables(scene.codebook)
    pj, pt, *_ = _pairs_both(spots, bits, cb)

    def table(p):
        """valid pairs as (i, j, region) rows, sorted, and their scores"""
        ok = np.asarray(p.ok)
        rows = np.stack([np.asarray(p.i)[ok], np.asarray(p.j)[ok],
                         np.asarray(p.region)[ok]], axis=1)
        order = np.lexsort(rows.T[::-1])
        return rows[order], np.asarray(p.score)[ok][order]

    (rows_t, score_t), (rows_j, score_j) = table(pt), table(pj)
    np.testing.assert_array_equal(rows_t, rows_j)
    assert len(rows_j) >= 50
    np.testing.assert_allclose(score_t, score_j, rtol=1e-5, atol=1e-5)
    n = len(spots)
    gj = jm.select_pairs(pj, n)
    gt = tm.select_pairs(pt, n)
    np.testing.assert_array_equal(gt.spot_idx.numpy(),
                                  np.asarray(gj.spot_idx))
    np.testing.assert_array_equal(gt.region.numpy(), np.asarray(gj.region))
    np.testing.assert_array_equal(gt.spot_usage.numpy(),
                                  np.asarray(gj.spot_usage))
    assert int(gt.n_selected) == int(gj.n_selected) > 0
    assert int(gt.dropped) == int(gj.dropped) == 0


def test_complete_tuples_matches_jax():
    """Full MerfishDecoder.decode, bucketed: the same tuples, regions and
    usage."""
    spots, bits, scene = _table(2)
    cb, _ = t_tables(scene.codebook)
    gj = jm.MerfishDecoder(cb).decode(spots, bits, bucket=512)
    gt = tm.MerfishDecoder(cb, device="cpu").decode(spots, bits, bucket=512)
    for field in ("spot_idx", "region", "n_spots", "ok", "spot_usage"):
        np.testing.assert_array_equal(getattr(gt, field).numpy(),
                                      np.asarray(getattr(gj, field)), field)
    assert int((np.asarray(gj.n_spots) == 3).sum()) >= 20


def test_decode_chromosome_homologs_matches_jax():
    """One chromosome's JAX groups through both homolog front doors: the
    same BB centres, flags, selected groups and traces (nm, 1e-3)."""
    spots, bits, scene = _table(3)
    cb, meta = t_tables(scene.codebook)
    gj = jm.MerfishDecoder(cb).decode(spots, bits)
    chr1 = {int(r) for r, c in zip(cb.ids, meta["chr"]) if c == "chr1"}
    sel = np.asarray(gj.ok) & np.isin(np.asarray(gj.region), list(chr1))
    sub = tm.SpotGroups(spot_idx=np.asarray(gj.spot_idx)[sel],
                        region=np.asarray(gj.region)[sel],
                        n_spots=np.asarray(gj.n_spots)[sel],
                        ok=np.asarray(gj.ok)[sel], spot_usage=None)
    rid = np.asarray(sub.region)
    rj = jh.decode_chromosome_homologs(sub, spots, rid)
    rt = th.decode_chromosome_homologs(sub, spots, rid, device="cpu")
    np.testing.assert_allclose(rt.centers.numpy(), np.asarray(rj.centers),
                               atol=1e-2)
    for field in ("zxys_valid", "sel_group", "flags"):
        np.testing.assert_array_equal(getattr(rt, field).numpy(),
                                      np.asarray(getattr(rj, field)), field)
    assert int(rt.n_iters) == int(rj.n_iters)
    np.testing.assert_allclose(rt.zxys.numpy(), np.asarray(rj.zxys),
                               atol=1e-3, equal_nan=True)
    np.testing.assert_allclose(rt.final_scores.numpy(),
                               np.asarray(rj.final_scores), rtol=1e-4,
                               atol=1e-5)
    assert int(np.asarray(rj.zxys_valid).sum()) >= 12


def test_init_homolog_centers_and_helpers_match_jax():
    rng = np.random.default_rng(5)
    cen = np.concatenate([rng.normal(0, 300, (20, 3)),
                          rng.normal(2000, 300, (20, 3))]).astype(np.float32)
    rid = np.tile(np.arange(20), 2)
    valid = np.ones(40, bool)
    valid[[3, 27]] = False
    cj = jh.init_homolog_centers(jnp.asarray(cen), jnp.asarray(rid),
                                 jnp.asarray(valid))
    ct = th.init_homolog_centers(torch.from_numpy(cen), torch.from_numpy(rid),
                                 torch.from_numpy(valid))
    for a, b in zip(ct, cj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    vals = rng.normal(0, 1, 40).astype(np.float32)
    for pct in (1.0, 37.5, 100.0):
        np.testing.assert_allclose(
            float(th._percentile_linear(torch.from_numpy(vals),
                                        torch.from_numpy(valid), pct)),
            float(jh._percentile_linear(jnp.asarray(vals), jnp.asarray(valid),
                                        pct)), rtol=1e-6)
    x = np.where(rng.random((7, 3)) < 0.3, np.nan, rng.normal(0, 1, (7, 3)))
    np.testing.assert_allclose(th._nanmedian_rows(torch.from_numpy(x)).numpy(),
                               np.nanmedian(x, axis=0), rtol=1e-12)


def test_dna_decoder_matches_jax_via_decoder_from_arrays():
    """The JAX DNAMerfishDecoder's codebook tables carried across: the same
    chromosomes, selected groups and traces."""
    spots, bits, scene = _table(4)
    jdec = jdna.DNAMerfishDecoder(pd.DataFrame(scene.codebook),
                                  keep_ratio_th=0.2)
    tdec = decoder_from_arrays(
        {"matrix": jdec.codebook.matrix, "ids": jdec.codebook.ids,
         "bit_values": jdec.codebook.bit_values,
         "chr": jdec.codebook_df["chr"].to_numpy(),
         "pixel_sizes": jdec.pixel_sizes},
        pair_search_radius=jdec.decoder.search_th,
        num_homologs=jdec.num_homologs, keep_ratio_th=jdec.keep_ratio_th,
        device="cpu")
    kw = dict(spot_bucket=1024, group_bucket=64)
    oj = jdec.decode(spots, bits, **kw)
    ot = tdec.decode(spots, bits, **kw)
    assert sorted(ot) == sorted(oj) == ["chr1", "chr2"]
    for c in oj:
        np.testing.assert_array_equal(ot[c].sel_group.numpy(),
                                      np.asarray(oj[c].sel_group))
        np.testing.assert_allclose(ot[c].zxys.numpy(), np.asarray(oj[c].zxys),
                                   atol=1e-3, equal_nan=True)
    zj, lj = jdec.summarize_zxys_all_chromosomes()
    zt, lt = tdec.summarize_zxys_all_chromosomes()
    assert lt == lj
    np.testing.assert_allclose(zt, zj, atol=1e-3, equal_nan=True)
    assert set(tdec.stage_seconds) == {"tuples", "homolog"}
    assert tdec.decode(spots[:5], bits[:5]) is None


def test_decoders_default_to_cuda_and_raise_without_it(monkeypatch):
    _, _, scene = _table()
    cb, _ = t_tables(scene.codebook)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.MerfishDecoder(cb)
    with pytest.raises(RuntimeError, match="CUDA"):
        decoder_from_arrays({"matrix": cb.matrix, "ids": cb.ids,
                             "bit_values": cb.bit_values,
                             "chr": scene.codebook["chr"],
                             "pixel_sizes": PX})
    assert tm.MerfishDecoder(cb, device="cpu").device.type == "cpu"
