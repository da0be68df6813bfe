"""PyTorch port vs JAX package: genome-wide summaries on the CPU.

A small out-of-order codebook (chromosomes 2, 1, X) with cells of one or
two homologs, some chromosomes missing in some cells, goes through both
packages as a DataFrame and, on the port, as a column mapping.  Summary
maps (float32 NaN medians of per-cell homolog distance maps) at rtol
1e-5 / atol 1e-5; plot orders, edges, merged region ids, interaction
groups (compared as sets) and dropped homologs equal; the assembled
matrix and contact probabilities at rtol 1e-5.  Density clouds are held
at rtol 1e-4 of their peak, the JAX test's own tolerance for a cloud's
normalisation (tests/test_genome.py holds the pdf's sum at rel 1e-4): the
JAX package's float32 sum over the grid is itself off by ~3e-5 there.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from imageanalysis3_tpu.analysis import genome as jg
from imageanalysis3_tpu_torch.analysis import genome as tg

torch.set_num_threads(2)

F32 = dict(rtol=1e-5, atol=1e-5)
SIZES = {"2": 3, "1": 4, "X": 2}


def _codebook():
    rows, rid = [], 0
    for chrom, n in SIZES.items():
        for k in range(n):
            rows.append({"id": rid, "chr": chrom, "chr_order": n - 1 - k})
            rid += 1
    return pd.DataFrame(rows)


def _columns(df):
    return {c: df[c].to_numpy() for c in df.columns}


def _cells(seed=0, n_cells=6):
    rng = np.random.default_rng(seed)
    cells = []
    for k in range(n_cells):
        cell = {}
        for chrom, n in SIZES.items():
            if chrom == "2" and k == 2:
                continue                       # chromosome 2 not seen
            h = 1 if chrom == "X" else 2
            z = rng.normal(size=(h, n, 3)).astype(np.float32)
            z[rng.uniform(size=(h, n)) < 0.15] = np.nan
            cell[chrom] = z
        cells.append(cell)
    return cells


def test_sort_chr_matches_jax():
    names = ["X", "2", "10", "1", "Y", "M"]
    assert sorted(names, key=tg.sort_chr) == sorted(names, key=jg.sort_chr)


@pytest.mark.parametrize("c1,c2", [("1", "2"), ("1", "1"), ("X", "X"),
                                   ("2", "X")])
def test_summarize_chr_pair_matches_jax(c1, c2):
    cells = _cells(1)
    got = tg.summarize_chr_pair(cells, c1, c2, SIZES, device="cpu")
    want = jg.summarize_chr_pair(cells, c1, c2, SIZES)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], **F32)


def test_summarize_missing_pair_and_other_reduction():
    cells = [{"1": np.ones((2, 4, 3), np.float32)}]
    got = tg.summarize_chr_pair(cells, "1", "2", SIZES, device="cpu")
    assert torch.isnan(got[("1", "2")]).all()
    assert got[("1", "2")].shape == (4, 3)
    cells = _cells(2)
    got = tg.summarize_chr_pair(cells, "1", "X", SIZES, function="nanmean",
                                device="cpu")
    want = jg.summarize_chr_pair(cells, "1", "X", SIZES, function="nanmean")
    np.testing.assert_allclose(got[("1", "X")].numpy(), want[("1", "X")],
                               **F32)


@pytest.mark.parametrize("as_frame", [True, False])
def test_genome_summary_and_matrix_match_jax(as_frame):
    cells, cb = _cells(3), _codebook()
    book = cb if as_frame else _columns(cb)
    got = tg.genome_summary_dict(cells, book, device="cpu")
    want = jg.genome_summary_dict(cells, cb)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], **F32)
    sel = cb.iloc[[0, 2, 3, 5, 7, 8]]
    for kw in ({}, {"use_cis": False, "use_trans": True},
               {"sort_by_region": False}):
        m, e, n = tg.assemble_dist_dict_to_matrix(
            got, book, sel if as_frame else _columns(sel), device="cpu",
            **kw)
        wm, we, wn = jg.assemble_dist_dict_to_matrix(want, cb, sel, **kw)
        np.testing.assert_allclose(m.numpy(), wm, **F32)
        np.testing.assert_array_equal(e, we)
        assert n == wn


@pytest.mark.parametrize("sort_by_region", [True, False])
def test_plot_order_and_edges_match_jax(sort_by_region):
    cb = _codebook()
    sel = cb.iloc[[1, 3, 4, 8]]
    got = tg.generate_plot_order(_columns(cb), _columns(sel), sort_by_region)
    want = jg.generate_plot_order(cb, sel, sort_by_region)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    ge = tg.generate_plot_chr_edges(_columns(sel),
                                    sort_by_region=sort_by_region)
    we = jg.generate_plot_chr_edges(sel, sort_by_region=sort_by_region)
    np.testing.assert_array_equal(ge[0], we[0])
    assert ge[1] == we[1]


@pytest.mark.parametrize("axis", [0, 1])
def test_contact_prob_matches_jax(axis):
    m = np.random.default_rng(4).uniform(0, 1.2, (7, 9)).astype(np.float32)
    m[2, :] = np.nan
    m[:, 3] = np.nan
    got = tg.contact_prob(m, 0.6, axis, device="cpu").numpy()
    with np.errstate(invalid="ignore"):
        want = jg.contact_prob(m, 0.6, axis)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("keep_valid", [False, True])
def test_center_and_merge_traces_match_jax(keep_valid):
    cell, cb = _cells(5)[0], _codebook()
    got = tg.center_chr_traces(cell, device="cpu")
    want = jg.center_chr_traces(cell)
    for c in want:
        np.testing.assert_allclose(got[c].numpy(), want[c], **F32)
    z, r = tg.merge_chr_traces(cell, cb, keep_valid, device="cpu")
    wz, wr = jg.merge_chr_traces(cell, cb, keep_valid)
    np.testing.assert_array_equal(z.numpy(), wz)
    np.testing.assert_array_equal(r.numpy(), wr)


def _hub_cell(seed):
    """Loci spread over a 10 um nucleus, with a 3-chromosome hub of
    regions 1 (chr 2), 4 (chr 1) and 7 (chr X) within 0.3 um."""
    rng = np.random.default_rng(seed)
    cell = {c: rng.uniform(0, 10, (1 if c == "X" else 2, n, 3))
            .astype(np.float32) for c, n in SIZES.items()}
    hub = rng.uniform(2, 8, 3)
    cell["2"][0, 1] = hub
    cell["1"][1, 0] = hub + [0.1, 0.0, 0.05]
    cell["X"][0, 1] = hub + [0.0, 0.12, -0.1]
    cell["1"][0, 2] = np.nan
    return cell


@pytest.mark.parametrize("seed,kw", [(6, {}), (7, {"min_chrs": 2,
                                                   "search_radius": 2.0})])
def test_find_interaction_groups_matches_jax(seed, kw):
    cell, cb = _hub_cell(seed), _codebook()
    got = tg.find_interaction_groups(cell, cb, device="cpu", **kw)
    want = jg.find_interaction_groups(cell, cb, **kw)
    as_set = lambda out: {tuple(r) for r in out[1]}
    assert as_set(got) == as_set(want)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g, w)
    if not kw:
        assert len(want[1]) >= 1


@pytest.mark.parametrize("kw", [{}, {"normalize_pdf": True},
                                {"normalize_counts": True,
                                 "return_empty": True}])
def test_chr_to_density_clouds_matches_jax(kw):
    rng = np.random.default_rng(8)
    n = 30
    good = rng.normal(scale=1.0, size=(n, 3)).astype(np.float32)
    bad = np.full((n, 3), np.nan, np.float32)
    cell = {"1": np.stack([good, bad]), "2": np.stack([good + 0.5]),
            "3": np.stack([good, good, good])}
    args = dict(pixel_size=0.5, im_radius=4.0, gaussian_sigma=0.5,
                min_valid_spots=10, **kw)
    got = tg.chr_to_density_clouds(cell, device="cpu", **args)
    want = jg.chr_to_density_clouds(cell, **args)
    assert list(got) == list(want)
    for c in want:
        assert got[c].shape == want[c].shape
        scale = max(float(np.abs(want[c]).max()), 1e-30)
        np.testing.assert_allclose(got[c].numpy() / scale, want[c] / scale,
                                   rtol=1e-4, atol=1e-4)
