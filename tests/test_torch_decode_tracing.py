"""The decode's spans in the port's timing record (``tracing``): a
``decode`` span around ``DNAMerfishDecoder.decode`` with its ``tuples`` and
``homolog`` spans, its candidates and groups, and its own count of the
host's waits on the card; outputs equal with recording on and off; the
benchmark's readers of those spans (``portbench/harness/decode_spans.py``)
and the ``seed_classify`` roofline's count."""

import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from imageanalysis3_tpu_torch import synthetic as tsyn  # noqa: E402
from imageanalysis3_tpu_torch import tracing  # noqa: E402
from imageanalysis3_tpu_torch.decode import DNAMerfishDecoder  # noqa: E402
from portbench.harness import decode_spans  # noqa: E402
from portbench.harness.peaks import peaks  # noqa: E402
from portbench.harness.trace import TraceSummary  # noqa: E402
from portbench.metrics import seed_classify_roofline  # noqa: E402
from portbench.roofline import seed_classify  # noqa: E402

torch.set_num_threads(2)
LAYOUT = tsyn.E2ELayout(center_z=20.0, origin=100.0, pitch=160.0,
                        grid_cols=2, z_clip=(8.0, 32.0),
                        xy_clip=(30.0, 370.0))


def _table(seed=1):
    scene = tsyn.make_e2e_scene(shape=(40, 400, 400), n_rounds=8,
                                n_data_ch=2, n_chr=2, n_per_chr=8,
                                n_distractors=40, seed=seed, layout=LAYOUT)
    rng = np.random.default_rng(seed)
    rows, bits = [], []
    for r in range(scene.n_rounds):
        for ci in range(scene.n_data_ch):
            b = r * scene.n_data_ch + ci
            pts = np.vstack([scene.bit_spots[b], scene.distractors[(r, ci)]])
            sp = np.zeros((len(pts), 11), np.float32)
            sp[:, 0] = rng.uniform(500, 3000, len(pts))
            sp[:, 1:4] = pts
            rows.append(sp)
            bits.append(np.full(len(pts), b + 1))
    return np.concatenate(rows), np.concatenate(bits), scene.codebook


@pytest.fixture
def clean_record():
    tracing.clear()
    yield
    tracing.clear()


def _same(a, b):
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


def test_decode_spans_and_counters(clean_record):
    spots, bits, codebook = _table()
    dec = DNAMerfishDecoder(codebook, keep_ratio_th=0.2, device="cpu")
    off = dec.decode(spots, bits)
    assert not tracing.record().loose and not tracing.record().rounds
    with tracing.recording():
        on = dec.decode(spots, bits)
    rec = tracing.record()
    assert not rec.rounds
    assert [s.name for s in rec.loose] == ["decode", "tuples", "homolog"]
    top, tuples, homolog = rec.loose
    assert tuples.parent is top and homolog.parent is top
    assert top.parent is None and top.round is None
    assert top.attrs["candidates"] == len(spots)
    assert top.attrs["groups"] == int(dec.spot_groups.ok.sum()) > 0
    # no card here: the decode waits on nothing
    assert top.attrs["syncs"] == 0 and top.attrs["unmarked_syncs"] == 0
    assert set(tracing.COUNTERS) <= set(top.attrs)
    assert "syncs" not in tuples.attrs
    assert set(dec.stage_seconds) == {"tuples", "homolog"}
    # outputs equal with recording on and off
    assert sorted(on) == sorted(off)
    for c in off:
        for field in off[c]._fields:
            a, b = getattr(off[c], field), getattr(on[c], field)
            if isinstance(a, torch.Tensor):
                assert _same(a, b), (c, field)
            else:
                assert a == b
    assert decode_spans.decode_syncs() == 0
    assert decode_spans.decode_device_ms() is None


@pytest.mark.parametrize("name", [tracing.DECODE, tracing.ROUND])
def test_counted_spans_count_waits(clean_record, name):
    """A decode span counts the waits torch's sync debug mode reports as a
    round span does, those outside a sync span as unmarked; a decode span
    inside a round counts its waits for both."""
    with tracing.recording():
        with tracing.span(name) as sp:
            warnings.warn(tracing.SYNC_WARNING + " (test)")
            with tracing.sync("site"):
                warnings.warn(tracing.SYNC_WARNING + " (test)")
        assert sp.attrs["syncs"] == 2 and sp.attrs["unmarked_syncs"] == 1
        with tracing.span(tracing.ROUND) as outer:
            with tracing.span(tracing.DECODE) as inner:
                warnings.warn(tracing.SYNC_WARNING + " (test)")
        assert outer.attrs["syncs"] == 1 and inner.attrs["syncs"] == 1


def test_a_traced_fov_fits_the_record():
    """The cell's traced window (trace_units FOVs of rounds_per_fov rounds
    and one decode each) fits what the record keeps."""
    with open(os.path.join(ROOT, "portbench", "configs",
                           "dna_merfish.json")) as fh:
        cfg = json.load(fh)
    with open(os.path.join(ROOT, "portbench", "traffic", "fov.json")) as fh:
        traffic = json.load(fh)
    units = traffic["trace_units"]
    assert tracing.MAX_ROUNDS >= units * cfg["rounds_per_fov"]
    assert tracing.MAX_LOOSE >= units * 3


class _Span:
    def __init__(self, name, device_ms, syncs):
        self.name, self.device_ms = name, device_ms
        self.attrs = {"syncs": syncs}


@pytest.mark.parametrize("loose, ms, syncs", [
    ([_Span("decode", 12.0, 7), _Span("tuples", 5.0, None),
      _Span("decode", 14.0, 9), _Span("decode", 10.0, 5)], 12.0, 7),
    ([_Span("homolog", 3.0, None)], None, None),
    ([], None, None)])
def test_decode_span_readers(monkeypatch, loose, ms, syncs):
    """Medians over the decode spans; nothing to read (a program without
    decode spans, as the parent of this cell) gives None."""
    monkeypatch.setattr(tracing, "record",
                        lambda: tracing.Record([], list(loose)))
    assert decode_spans.decode_device_ms() == ms
    assert decode_spans.decode_syncs() == syncs


def _config(shape):
    with open(os.path.join(ROOT, "portbench", "configs",
                           "dna_merfish.json")) as fh:
        cfg = json.load(fh)
    return dict(cfg, shape=list(shape))


@pytest.mark.parametrize("shape, nbytes, cuda_ops, tensor_ops", [
    ((60, 2048, 2048), 12 * 251658240 + 40, 81 * 251658240,
     732 * 251658240),
    ((2, 4, 4), 12 * 32 + 40, 81 * 32, 732 * 32)])
def test_seed_classify_roofline_count(shape, nbytes, cuda_ops, tensor_ops):
    """Bytes: two z-passed stacks read, qdiff written, 10 level counts;
    CUDA-core operations: the 7-tap fg passes (2 x 13) and 55 more a voxel;
    tensor-core: the 61-tap bg passes (2 x 122) three times (split TF32)."""
    cfg = _config(shape)
    assert seed_classify.counts(cfg) == (nbytes, cuda_ops, tensor_ops)
    pk = peaks("NVIDIA H100 80GB HBM3")
    t, by = seed_classify.least(cfg, pk)
    ops_t = cuda_ops / 67.0e12 + tensor_ops / 494.5e12
    assert by == ("bytes" if nbytes / 3.35e12 >= ops_t else "operations")
    assert t == pytest.approx(max(nbytes / 3.35e12, ops_t), rel=1e-12)


def test_seed_classify_roofline_reader():
    """The least time of each launch at the configuration's shape over the
    launches' device time: 0.9015 ms bytes-bound at 60x2048x2048, so a
    5.59 ms launch reads 16.1 %; no launch, nothing."""
    cfg = _config((60, 2048, 2048))

    class Run:
        config = cfg
        peaks = peaks("NVIDIA H100 80GB HBM3")

        @staticmethod
        def roofline(kernel):
            assert kernel == "seed_classify"
            return seed_classify

    def summary(kernels):
        return TraceSummary(window_s=1.0, busy_s=1.0, kernels=kernels,
                            h2d_s=0.0, h2d_count=0, device_ops=[],
                            idle_gaps=[])

    run = Run()
    run.trace = summary({"seed_classify_mma_kernel": [40, 40 * 5.59e-3],
                         "lm_fit_kernel<2>": [240, 0.1]})
    share = seed_classify_roofline.read(run)
    assert share == pytest.approx(100 * 0.9014623641791045e-3 / 5.59e-3,
                                  rel=1e-9)
    run.trace = summary({"lm_fit_kernel<2>": [240, 0.1]})
    assert seed_classify_roofline.read(run) is None
