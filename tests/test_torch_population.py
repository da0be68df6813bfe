"""PyTorch port vs JAX package: population analysis on the CPU.

BED overlap exactly; the domain 2-means labels equal (its separation
matrix from ``domain_pdists`` on the device, its initial labels from the
same NumPy generator).  The cell-type classifier: the JAX package fits a
scikit-learn ``MLPClassifier``; its fitted ``coefs_`` / ``intercepts_``,
classes and count normalisation cross over by
``convert.classifier_from_arrays`` and the port's ``predict`` must equal
scikit-learn's, ``predict_proba`` agree to 1e-6.  The port's own training
is held to the JAX test's planted task and bar (held-out score >= 0.9),
and on three types to the JAX classifier's own held-out score, not to
scikit-learn's weights.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from imageanalysis3_tpu.analysis import population as jpop
from imageanalysis3_tpu_torch.analysis import population as tpop
from imageanalysis3_tpu_torch.convert import classifier_from_arrays

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]

#: the analysis modules where pandas, h5py and scikit-learn do not import
ANALYSIS_WITHOUT_LIBRARIES = """
import sys
for name in ("pandas", "h5py", "sklearn", "jax", "imageanalysis3_tpu"):
    sys.modules[name] = None
import numpy as np
from imageanalysis3_tpu_torch import analysis as an
rng = np.random.default_rng(0)
clf = an.CellTypeClassifier(hidden=(4,), max_iter=5, device="cpu")
clf.fit(rng.poisson(3, (20, 6)), ["a"] * 10 + ["b"] * 10)
assert clf.predict(rng.poisson(3, (3, 6))).shape == (3,)
book = {"id": np.arange(4), "chr": np.array(["1", "1", "2", "X"]),
        "chr_order": np.array([0, 1, 0, 0])}
cells = [{"1": rng.normal(size=(2, 2, 3)), "2": rng.normal(size=(2, 1, 3)),
          "X": rng.normal(size=(1, 1, 3))} for _ in range(3)]
assert len(an.genome_summary_dict(cells, book, device="cpu")) == 9
lab = np.zeros((2, 8, 8), np.int32)
lab[:, 2:5, 2:5] = 3
table = an.segmentation_to_cell_locations(lab, device="cpu")
assert table["volume"].tolist() == [18]
print("ok")
"""


def test_bed_overlap_matches_jax(tmp_path):
    bed = tmp_path / "peaks.bed"
    bed.write_text("track name=x\n# comment\n1\t100\t200\n1 150 400\n"
                   "2\t0\t50\n\n")
    got, want = tpop.load_bed(str(bed)), jpop.load_bed(str(bed))
    assert got.tolist() == want.tolist()
    regions = {0: {"chr": "1", "start": 120, "end": 220},
               1: {"chr": "2", "start": 10, "end": 110},
               2: {"chr": "3", "start": 0, "end": 10},
               3: {"chr": "1", "start": 5, "end": 5}}
    a = tpop.region_overlap_fraction(regions, got)
    b = jpop.region_overlap_fraction(regions, want)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k]))


def _compartment_trace(seed):
    """Alternating A / B blocks: A blocks cluster near one centre, B near
    another, so the 2-means splits them."""
    rng = np.random.default_rng(seed)
    sizes = [10, 8, 12, 9, 10, 8]
    centres = [(0, 0, 0), (3000, 0, 0)]
    z = np.concatenate([np.asarray(centres[k % 2], float)
                        + rng.normal(0, 300, (s, 3))
                        for k, s in enumerate(sizes)])
    z[rng.uniform(size=len(z)) < 0.08] = np.nan
    return z, np.cumsum([0] + sizes[:-1])


@pytest.mark.parametrize("seed,marker", [(0, False), (1, True)])
def test_assign_compartments_from_domains_matches_jax(seed, marker):
    z, starts = _compartment_trace(seed)
    frac = ({r: float(r < 10 or 18 <= r < 30) for r in range(len(z))}
            if marker else None)
    got = tpop.assign_compartments_from_domains(z, starts, frac,
                                                device="cpu")
    want = jpop.assign_compartments_from_domains(z, starts, frac)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert len(set(got[0][::2])) == 1 and got[0][0] != got[0][1]
    one = tpop.assign_compartments_from_domains(z, [0], device="cpu")
    assert one[0].shape == (1,) and not one[1].any()


def _counts(seed=5, n=120, n_types=2):
    rng = np.random.default_rng(seed)
    counts = rng.poisson(2, (n, 10)).astype(float)
    labels = np.repeat(np.array(["A", "B", "C"][:n_types]), n // n_types)
    for t in range(n_types):
        counts[labels == labels[t * (n // n_types)], t] += \
            rng.poisson(30, n // n_types)
    return counts, labels


@pytest.mark.parametrize("n_types", [2, 3])
def test_classifier_from_sklearn_weights_predicts_as_jax(n_types):
    counts, labels = _counts(n_types=n_types)
    clf = jpop.CellTypeClassifier(hidden=(16,), max_iter=300)
    clf.fit(counts[::2], labels[::2])
    port = classifier_from_arrays(clf.model.coefs_, clf.model.intercepts_,
                                  clf.model.classes_, clf._norm,
                                  device="cpu")
    test = counts[1::2]
    np.testing.assert_array_equal(port.predict(test), clf.predict(test))
    mu, sd = clf._norm
    want = clf.model.predict_proba((clf._lognorm(test) - mu) / sd)
    np.testing.assert_allclose(port.predict_proba(test), want, rtol=0,
                               atol=1e-6)
    assert port.score(test, labels[1::2]) == clf.score(test, labels[1::2])


@pytest.mark.parametrize("n_types", [2, 3])
def test_classifier_trains_to_the_jax_bar(n_types):
    counts, labels = _counts(n_types=n_types)
    clf = tpop.CellTypeClassifier(hidden=(16,), max_iter=300, device="cpu")
    clf.fit(counts[::2], labels[::2])
    if n_types == 2:
        bar = 0.9                  # tests/test_structure.py's bar
    else:
        ref = jpop.CellTypeClassifier(hidden=(16,), max_iter=300)
        ref.fit(counts[::2], labels[::2])
        bar = ref.score(counts[1::2], labels[1::2])
    assert clf.score(counts[1::2], labels[1::2]) >= bar
    assert 1 <= clf.n_iter_ <= 300
    # the seed fixes the initial weights and the batch order
    a, b = (tpop.CellTypeClassifier(hidden=(16,), max_iter=20, seed=3,
                                    device="cpu") for _ in range(2))
    a.fit(counts[::2], labels[::2])
    b.fit(counts[::2], labels[::2])
    np.testing.assert_array_equal(a.predict_proba(counts),
                                  b.predict_proba(counts))


def test_analysis_runs_without_pandas_h5py_or_sklearn():
    """The classifier, a genome summary and a cell table where pandas, h5py,
    scikit-learn and JAX do not import."""
    out = subprocess.run([sys.executable, "-c", ANALYSIS_WITHOUT_LIBRARIES],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok"
