"""The port's span record (``imageanalysis3_tpu_torch.tracing``) on a small
CPU round: nothing recorded when off; under ``tracing.recording()`` and
under ``torch.profiler`` the span tree of ``process_round`` and
``process_round_raw``; outputs bit for bit the same either way; spans on
the profiler's clock, each holding the aten ops the profiler places in
it; a round's count of its waits on the card; ``StageTimes`` stages as
records on the host clock."""

import re
import threading
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from imageanalysis3_tpu_torch import synthetic as tsyn
from imageanalysis3_tpu_torch import tracing
from imageanalysis3_tpu_torch.config import (ExperimentConfig, FitConfig,
                                             SeedConfig)
from imageanalysis3_tpu_torch.pipeline import FovPipeline, StageTimes
from imageanalysis3_tpu_torch.pipeline import fov as fov_mod

torch.set_num_threads(2)
SHAPE = (12, 128, 128)
#: radius 7 puts neighbours within 2r of some spots, so the fit refits
FIT = FitConfig(radius=7, lm_iters=6, n_max_iter=2)
#: each stage's span, and the functions called only inside it
INSIDE = {"correct": ("correct_channel_stack",),
          "drift": ("subpixel_phase_correlation_prepared", "consensus_drift"),
          "seed": ("get_seeds",),
          "fit": ("gather_blocks", "neighbor_lists", "warp_spot_coords"),
          "refit": ("_recon_at",)}


@pytest.fixture(scope="module")
def scene():
    fov = tsyn.make_synthetic_fov(shape=SHAPE, n_rounds=2, n_channels=2,
                                  n_spots=30, seed=3, drift_scale=2.0)
    ims = torch.from_numpy(np.clip(fov.ims, 0, 65535).astype(np.int32))
    cfg = ExperimentConfig(image_size=SHAPE, fit=FIT,
                           seed=SeedConfig(th_seed=300.0, max_num_seeds=16))
    pipe = FovPipeline(cfg, n_channels=2, drift_channel_index=1,
                       fit_channel_indices=(0, 1),
                       illumination=fov.illumination.astype(np.float32),
                       image_shape=SHAPE, device="cpu")
    ref = pipe.prepare_reference(pipe.correct_reference(ims[0]))
    # the round as a raw frame window: frame 2z + c holds channel c
    raw = ims[1].permute(1, 0, 2, 3).reshape(-1, *SHAPE[1:]).contiguous()
    return pipe, ref, ims[1], raw


def _both(pipe, ref, stack, raw):
    return (pipe.process_round(stack, ref),
            pipe.process_round_raw(raw, ref, (0, 1), 2))


@pytest.fixture(scope="module")
def unrecorded(scene):
    tracing.clear()
    out = _both(*scene)
    return out, tracing.record()


def test_off_records_nothing(unrecorded):
    _, rec = unrecorded
    assert rec.rounds == [] and rec.loose == []


def _children(spans, parent, name=None):
    return [s for s in spans if s.parent is parent
            and (name is None or s.name == name)]


@pytest.mark.parametrize("how", ["recording", "profiler"])
def test_span_tree_of_a_round(scene, unrecorded, monkeypatch, how):
    fits = []
    fit = fov_mod.iter_fit_seed_points

    def counted(*a, **k):
        fits.append(fit(*a, **k))
        return fits[-1]

    monkeypatch.setattr(fov_mod, "iter_fit_seed_points", counted)
    tracing.clear()
    if how == "recording":
        with tracing.recording():
            out = _both(*scene)
    else:
        with profile(activities=[ProfilerActivity.CPU]):
            out = _both(*scene)
    # outputs bit for bit those of the unrecorded calls
    for got, want in zip(out, unrecorded[0]):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    rec = tracing.record()
    assert rec.loose == [] and len(rec.rounds) == 2
    assert len(fits) == 4
    ids = set()
    for k, spans in enumerate(rec.rounds):
        rnd = spans[0]
        assert rnd.name == tracing.ROUND and rnd.parent is None
        ids.add(rnd.round)
        for s in spans:
            # one round id, a parent chain up to the round, nested times
            assert s.round == rnd.round
            p = s
            while p.parent is not None:
                assert p.parent.start_ns <= p.start_ns <= p.end_ns \
                    <= p.parent.end_ns
                p = p.parent
            assert p is rnd
            assert s.device_ms is None          # no CUDA events on the CPU
        top = [s.name for s in _children(spans, rnd) if s.name != "sync"]
        # streaming: the drift channel (1) corrects first and is fit last
        want = ["correct", "drift", "correct", "fit", "fit"]
        assert top == (["input"] + want if k == 1 else want)
        assert [s.attrs["channel"] for s in _children(spans, rnd, "correct")
                ] == [1, 0]
        assert [s.attrs["channel"] for s in _children(spans, rnd, "fit")
                ] == [0, 1]
        for f, res in zip(_children(spans, rnd, "fit"), fits[2 * k:]):
            names = [s.name for s in _children(spans, f)]
            n = int(res.n_rounds)
            assert names.count("seed") == 1
            assert names.count("refit") == n
            checks = [s for s in _children(spans, f, "sync")
                      if s.attrs["site"] == "refit_check"]
            assert len(checks) == n + (n < FIT.n_max_iter)
        assert len(_children(spans, rnd, "drift")) == 1
        if k == 1:
            (inp,) = _children(spans, rnd, "input")
            assert [s.attrs["site"] for s in _children(spans, inp, "sync")
                    ] == ["upload"]
        assert all(s.attrs["site"] for s in spans if s.name == "sync")
        # no wait on the card on the CPU
        assert rnd.attrs["syncs"] == rnd.attrs["unmarked_syncs"] == 0
    assert len(ids) == 2
    assert any(int(r.n_rounds) > 0 for r in fits)


def test_aten_ops_fall_inside_their_spans_on_the_profiler_clock(scene):
    """Each aten op under a function that runs only inside one stage's
    span lies, on the profiler's clock, within a span of that stage."""
    pipe, ref, stack, _ = scene
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU], with_stack=True) as prof:
        pipe.process_round(stack, ref)
    (spans,) = tracing.record().rounds
    owner = {fn: name for name, fns in INSIDE.items() for fn in fns}
    seen = dict.fromkeys(INSIDE, 0)
    todo = [(node, None)
            for node in prof.profiler.kineto_results.experimental_event_tree()]
    while todo:
        node, stage = todo.pop()
        if stage is None:
            m = re.search(r"\): (\w+)$", node.name)
            stage = owner.get(m.group(1)) if m else None
        elif node.name.startswith("aten::"):
            seen[stage] += 1
            assert any(s.name == stage and s.start_ns <= node.start_time_ns
                       and node.end_time_ns <= s.end_ns for s in spans), \
                (stage, node.name)
        todo.extend((c, stage) for c in node.children)
    assert min(seen.values()) > 0, seen


def test_span_host_times_match_profiler_events():
    """time.time_ns() is the clock of the profiler's events:
    trace_start_ns() plus an event's time_range (us)."""
    x = torch.ones(1000)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with tracing.span("add"):
                x.add_(1)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ops = [e for e in prof.events() if e.name == "aten::add_"]
    spans = tracing.record().loose
    assert len(ops) == len(spans) == 5
    for e, s in zip(ops, spans):
        assert s.start_ns <= t0 + e.time_range.start * 1000
        assert t0 + e.time_range.end * 1000 <= s.end_ns


def test_record_keeps_the_last_rounds_and_spans_of_threads_apart():
    tracing.clear()
    with tracing.recording():
        for _ in range(tracing.MAX_ROUNDS + 3):
            with tracing.span(tracing.ROUND):
                with tracing.span("inner"):
                    pass
        def load():
            with tracing.span("load"):
                pass

        with tracing.span(tracing.ROUND) as rnd:
            t = threading.Thread(target=load)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    rec = tracing.record()
    assert len(rec.rounds) == tracing.MAX_ROUNDS
    ids = [g[0].round for g in rec.rounds]
    assert ids == list(range(ids[0], ids[0] + tracing.MAX_ROUNDS))
    assert rec.rounds[-1] == [rnd]
    assert [s.name for s in rec.loose] == ["load"]
    assert rec.loose[0].parent is None and rec.loose[0].round is None
    tracing.clear()
    assert tracing.record() == ([], [])


def test_a_round_counts_its_waits_on_the_card():
    """A recorded round counts torch's sync warnings instead of showing
    them, those outside a sync span apart; other warnings pass, and the
    warning filters come back as they were."""
    filters = list(warnings.filters)
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        with tracing.recording():
            with tracing.span(tracing.ROUND) as rnd:
                with tracing.sync("upload"):
                    warnings.warn(tracing.SYNC_WARNING)
                with tracing.span("fit"):
                    warnings.warn(tracing.SYNC_WARNING)
                    with tracing.sync("refit_check"):
                        warnings.warn(tracing.SYNC_WARNING)
                warnings.warn("something else")
        warnings.warn(tracing.SYNC_WARNING)       # no round open
    assert rnd.attrs == {"syncs": 3, "unmarked_syncs": 1, "const_builds": 0}
    assert [str(w.message) for w in shown] == ["something else",
                                               tracing.SYNC_WARNING]
    assert warnings.filters == filters
    with tracing.span(tracing.ROUND) as off:
        pass
    assert off is not rnd and not isinstance(off, tracing.Span)


def test_stage_times_are_spans_that_hold_the_round(scene):
    """A stage's record holds the time of the round inside it, on the host
    clock; stages open no span, so the round is the record's top."""
    pipe, ref, stack, _ = scene
    times = StageTimes()
    times.add("store_open", 0.5, backend="npy")
    tracing.clear()
    with times.stage("process_round", folder="H1") as rec:
        pipe.process_round(stack, ref)
    assert tracing.record() == ([], [])       # off: a record, no span
    rec["seconds"] += 1.0
    with tracing.recording():
        with times.stage("process_round", folder="H2"):
            pipe.process_round(stack, ref)
    assert [(r["stage"], r.get("folder")) for r in times.records] == [
        ("store_open", None), ("process_round", "H1"),
        ("process_round", "H2")]
    assert times.records[1]["seconds"] > 1.0
    assert set(times.summary()) == {"store_open", "process_round"}
    assert times.total("process_round") == pytest.approx(
        times.records[1]["seconds"] + times.records[2]["seconds"])
    rec = tracing.record()
    (spans,) = rec.rounds
    assert rec.loose == [] and spans[0].parent is None
    assert times.records[2]["seconds"] >= spans[0].host_ms / 1e3
