"""The readers of the program's span metrics on a hand-built record of two
rounds, on an empty record, and on a program without the recorder."""

import builtins
import sys
from types import SimpleNamespace

import pytest

from portbench.harness import spans
from portbench.harness.spec import metric_reader

NAMES = ["correct_span_ms", "drift_span_ms", "seed_span_ms", "fit_span_ms",
         "input_span_ms", "host_own_ms", "host_syncs", "refit_rounds"]


def _span(name, host_ms=0.0, device_ms=None, **attrs):
    return SimpleNamespace(name=name, host_ms=host_ms, device_ms=device_ms,
                           attrs=attrs)


def _round(corrects, drift, fits, host_ms, syncs, upload=None):
    """A round: its correct / drift / fit event ms, each fit (seed ms,
    refits), its host ms and its sync spans as (host ms, waits counted in
    them)."""
    out = [_span("round", host_ms, device_ms=sum(corrects) + drift,
                 syncs=sum(w for _, w in syncs))]
    if upload is not None:
        out.append(_span("input", device_ms=upload))
    out += [_span("correct", device_ms=c, channel=i)
            for i, c in enumerate(corrects)]
    out.append(_span("drift", device_ms=drift))
    for total, seed, refits in fits:
        out += [_span("fit", device_ms=total), _span("seed", device_ms=seed)]
        out += [_span("refit", device_ms=1.0) for _ in range(refits)]
    out += [_span("sync", h, site="s") for h, _ in syncs]
    return out


RECORD = [
    _round([10.0, 12.0, 11.0], 7.0, [(17.0, 2.0, 1), (19.0, 3.0, 2)], 80.0,
           [(5.0, 1), (2.0, 6)], upload=14.0),
    _round([11.0, 12.0, 12.0], 5.0, [(15.0, 4.0, 0), (21.0, 5.0, 3)], 90.0,
           [(1.0, 1), (3.0, 1), (4.0, 2)], upload=16.0),
]

WANT = {"correct_span_ms": 34.0, "drift_span_ms": 6.0, "seed_span_ms": 3.5,
        "fit_span_ms": 18.0, "input_span_ms": 15.0,
        "host_own_ms": (73.0 + 82.0) / 2, "host_syncs": (7 + 4) / 2,
        "refit_rounds": 6 / 4}


@pytest.mark.parametrize("name", NAMES)
def test_reader_on_a_hand_built_record(name, monkeypatch):
    monkeypatch.setattr(spans, "window_rounds", lambda: RECORD)
    assert metric_reader(name)(None) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", NAMES)
def test_reader_on_an_empty_record(name, monkeypatch):
    monkeypatch.setattr(spans, "window_rounds", lambda: None)
    assert metric_reader(name)(None) is None


def test_spans_without_device_intervals_give_no_device_metric(monkeypatch):
    """On the CPU spans carry no event interval: the device metrics read
    nothing, the host ones still do; a round with no input span is no
    input."""
    cpu = [[_span(s.name, s.host_ms, None, **s.attrs) for s in r]
           for r in RECORD]
    monkeypatch.setattr(spans, "window_rounds", lambda: cpu)
    for name in NAMES[:5]:
        assert metric_reader(name)(None) is None, name
    assert metric_reader("host_syncs")(None) == WANT["host_syncs"]
    no_input = [[s for s in r if s.name != "input"] for r in RECORD]
    monkeypatch.setattr(spans, "window_rounds", lambda: no_input)
    assert metric_reader("input_span_ms")(None) is None
    assert metric_reader("correct_span_ms")(None) == WANT["correct_span_ms"]


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    real = builtins.__import__

    def no_tracing(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "imageanalysis3_tpu_torch" and "tracing" in (fromlist or ()):
            raise ImportError("cannot import name 'tracing'")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.delitem(sys.modules, "imageanalysis3_tpu_torch.tracing",
                        raising=False)
    monkeypatch.setattr(builtins, "__import__", no_tracing)
    assert spans.window_rounds() is None
    for name in NAMES:
        assert metric_reader(name)(None) is None


def test_the_program_record_is_read(monkeypatch):
    """With the recorder, the readers read its rounds."""
    import warnings

    from imageanalysis3_tpu_torch import tracing

    tracing.clear()
    assert spans.window_rounds() is None
    with tracing.recording():
        for _ in range(2):
            with tracing.span(tracing.ROUND):
                with tracing.span("fit"):
                    with tracing.sync("refit_check"):
                        warnings.warn(tracing.SYNC_WARNING)
                    with tracing.span("refit"):
                        pass
    assert len(spans.window_rounds()) == 2
    assert metric_reader("refit_rounds")(None) == 1.0
    assert metric_reader("host_syncs")(None) == 1
    assert metric_reader("host_own_ms")(None) >= 0.0
    assert metric_reader("fit_span_ms")(None) is None    # the CPU
    tracing.clear()
