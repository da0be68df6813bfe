"""The benchmark's plain decode reference (``portbench/reference/decode.py``)
against the JAX package's ``DNAMerfishDecoder`` and the port's, on the CPU,
on seeded candidate tables of small ``make_e2e_scene`` scenes: the same
decoded groups (as sets of (region, spot ids)) and the same homolog traces;
and the decode numbers of ``portbench/harness/decode_check.py`` reading 0
on identical decodes and failing each planted decode fault."""

import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from imageanalysis3_tpu.decode import dna_decoder as jdna  # noqa: E402
from imageanalysis3_tpu_torch import synthetic as tsyn  # noqa: E402
from imageanalysis3_tpu_torch.decode import DNAMerfishDecoder  # noqa: E402
from portbench.harness import decode_check  # noqa: E402
from portbench.reference import decode as rdec  # noqa: E402

torch.set_num_threads(2)
PX = np.array([200.0, 108.0, 108.0], np.float32)
LAYOUT = tsyn.E2ELayout(center_z=20.0, origin=100.0, pitch=160.0,
                        grid_cols=2, z_clip=(8.0, 32.0),
                        xy_clip=(30.0, 370.0))


def _table(seed, n_distractors=60):
    """Candidate rows (N, 11) and 1-based bits of a 2-chromosome x 8 region
    x 2 homolog scene over 16 bits, and its codebook columns."""
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
            sp[:, 1:4] = pts + rng.normal(0, 0.05, pts.shape)
            sp[:, 5:8] = 1.5
            rows.append(sp)
            bits.append(np.full(len(pts), b + 1))
    return np.concatenate(rows), np.concatenate(bits), scene.codebook


def _reference(spots, bits, codebook):
    return rdec.decode_fov(spots, bits, codebook, PX, search_th=250.0,
                           num_homologs=2, keep_ratio_th=0.2, device="cpu")


def _region_chr(codebook):
    return {int(i): str(c) for i, c in zip(codebook["id"], codebook["chr"])}


def _port(spots, bits, codebook):
    dec = DNAMerfishDecoder(codebook, pixel_sizes=PX, keep_ratio_th=0.2,
                            device="cpu")
    return decode_check.program_decoded(dec, dec.decode(spots, bits),
                                        _region_chr(codebook))


def _jax(spots, bits, codebook):
    dec = jdna.DNAMerfishDecoder(pd.DataFrame(codebook), pixel_sizes=PX,
                                 keep_ratio_th=0.2)
    out = dec.decode(spots, bits)
    g = dec.spot_groups
    ok = np.asarray(g.ok)
    regions = np.asarray(g.region)[ok].astype(np.int64)
    groups = [(int(r), tuple(sorted(int(s) for s in row if s >= 0)))
              for r, row in zip(regions, np.asarray(g.spot_idx)[ok])]
    chr_of = _region_chr(codebook)
    traces = {name: rdec.Traces(
        np.unique([r for r in regions if chr_of[int(r)] == name]),
        np.asarray(res.zxys), np.asarray(res.zxys_valid))
        for name, res in out.items()}
    return rdec.Decoded(groups, traces)


def _assert_same(a, b, atol):
    assert set(a.groups) == set(b.groups)
    assert sorted(a.traces) == sorted(b.traces)
    for name in a.traces:
        np.testing.assert_array_equal(a.traces[name].regions,
                                      b.traces[name].regions)
        np.testing.assert_array_equal(a.traces[name].assigned,
                                      b.traces[name].assigned)
        np.testing.assert_allclose(a.traces[name].zxys, b.traces[name].zxys,
                                   atol=atol, equal_nan=True)


@pytest.mark.parametrize("seed", [0, 3, 5])
@pytest.mark.parametrize("other", ["port", "jax"])
def test_reference_decode_matches(seed, other):
    """The reference decodes the same groups and traces as the port (bit
    for bit: the same float32 arithmetic, without the padding) and as the
    JAX package (traces at its float32 tolerance)."""
    spots, bits, codebook = _table(seed)
    ref = _reference(spots, bits, codebook)
    assert len(ref.groups) >= 20 and len(ref.traces) == 2
    if other == "port":
        _assert_same(_port(spots, bits, codebook), ref, atol=0.0)
    else:
        _assert_same(_jax(spots, bits, codebook), ref, atol=1e-3)


def test_reference_decode_refuses_too_few_candidates():
    spots, bits, codebook = _table(0)
    assert _reference(spots[:5], bits[:5], codebook) is None
    assert decode_check.compare(None, None, 32)["trace_gap_nm"] == 0.0
    assert decode_check.compare(None, _reference(spots, bits, codebook),
                                32)["assigned_gap"] == float("inf")


def _swapped_group(d):
    """Two groups of different regions exchange a member spot."""
    g = list(d.groups)
    i = next(k for k in range(1, len(g)) if g[k][0] != g[0][0])
    (r0, s0), (r1, s1) = g[0], g[i]
    g[0] = (r0, tuple(sorted((s1[0],) + s0[1:])))
    g[i] = (r1, tuple(sorted((s0[0],) + s1[1:])))
    return d._replace(groups=g)


def _crossed_homologs(d):
    """In one chromosome, the two homologs' points of every other region
    exchanged (a whole-chromosome label swap is the same answer)."""
    name = sorted(d.traces)[0]
    t = d.traces[name]
    z, m = t.zxys.copy(), t.assigned.copy()
    z[:, ::2] = z[::-1, ::2]
    m[:, ::2] = m[::-1, ::2]
    return d._replace(traces=dict(d.traces, **{name: t._replace(
        zxys=z, assigned=m)}))


def _moved_point(d):
    """One assigned trace point 5 nm off in x."""
    name = sorted(d.traces)[0]
    t = d.traces[name]
    z = t.zxys.copy()
    h, r = np.argwhere(t.assigned)[0]
    z[h, r, 1] += 5.0
    return d._replace(traces=dict(d.traces, **{name: t._replace(zxys=z)}))


def _dropped_point(d):
    """One assigned trace point left unassigned."""
    name = sorted(d.traces)[0]
    t = d.traces[name]
    m = t.assigned.copy()
    h, r = np.argwhere(m)[0]
    m[h, r] = False
    return d._replace(traces=dict(d.traces, **{name: t._replace(
        assigned=m)}))


def _limits():
    import json
    with open(os.path.join(ROOT, "portbench", "workloads",
                           "dna_merfish.fov.json")) as fh:
        return json.load(fh)["limits"]


@pytest.mark.parametrize("fault, number", [
    (None, None),
    (_swapped_group, "group_mismatch_share"),
    (_crossed_homologs, "trace_gap_nm"),
    (_moved_point, "trace_gap_nm"),
    (_dropped_point, "assigned_gap")])
def test_decode_numbers_fail_each_planted_fault(fault, number):
    """The port's decode against the reference's: every number 0; each
    fault planted in the port's decode fails the cell's limit on its
    number.  The cell's scale is 300 (region, homolog) cells; this scene's
    64 are counted as the cell counts them."""
    spots, bits, codebook = _table(3)
    ref = _reference(spots, bits, codebook)
    prog = _port(spots, bits, codebook)
    n_cells = 2 * 8 * 2
    limits = _limits()
    if fault is None:
        got = decode_check.compare(prog, ref, n_cells)
        assert got == {"group_mismatch_share": 0.0, "trace_gap_nm": 0.0,
                       "assigned_gap": 0.0}
        return
    got = decode_check.compare(fault(prog), ref, n_cells)
    assert not got[number] <= limits[number], got
