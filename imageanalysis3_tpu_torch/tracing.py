"""The port's one timing record: spans inside a round and around a field
of view's decode, and the per-stage times of ``ExperimentDriver`` and
``DNAMerfishDecoder`` (:class:`StageTimes`, kept as dicts on the host
clock).

A span records its name, its start and end on the host, the span it sits
in, the round it belongs to (every span of one ``round`` span shares that
round's id) and a few attributes (the channel, a sync's site).  While it
records, a span also records two CUDA events on the current stream, at
entry and at exit; its *event interval* (:attr:`Span.device_ms`) is the
time between them, from the card reaching the span's work to the card
finishing it, launch gaps inside included.  In a round whose host launches
slower than the card runs, that interval follows the host's pace (under
the profiler, the profiler's per-op cost too), not the device time of the
span's kernels.  A ``sync`` span marks a point where the host waits for
the card (a value read, a copy from pageable memory); it records no event.

A recorded ``round`` or ``decode`` span (:data:`COUNTED`) also counts the
host's waits on the card while it is open (attribute ``syncs``): it turns
on
``torch.cuda.set_sync_debug_mode("warn")`` and counts the warning torch
gives at each synchronising call instead of showing it (it is shown only
if the mode was on before), and counts as ``unmarked_syncs`` those outside
any ``sync`` span, whose waits the round's host time then holds.  It also
holds, under each name of :data:`COUNTERS`, how much that counter
(:func:`count`) grew while it was open: ``const_builds``, the device
constants built and copied to their device (``device.device_constant``), 0
once earlier calls on the same shapes have built them.  The counts cover
every thread of the process; rounds are recorded from one thread at a
time.  A counted span inside another counts its waits for both.

Recording is on while ``torch.profiler`` profiles
(``torch.autograd._profiler_enabled()``) or inside ``with recording():``.
Off, a span is one flag check that returns a shared no-op context manager.
Spans are not ``record_function`` ranges: those come back from the
profiler as device-side annotations, which a trace's device activity would
count.  Host times are ``time.time_ns()``, the clock of the profiler's
trace (its ``kineto_results.trace_start_ns()`` plus an event's
``time_range`` in microseconds), so a span can be laid over the trace.

Recording adds no host synchronisation: recording a CUDA event does not
wait for the card, and elapsed times are resolved when the record is read
(:attr:`Span.device_ms` waits for the span's end event).

The record is bounded: the last :data:`MAX_ROUNDS` rounds, each with all
its spans, and the last :data:`MAX_LOOSE` spans outside any round (a
``decode`` span and its ``tuples`` and ``homolog`` spans among them).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, NamedTuple, Optional

import torch

__all__ = ["Span", "Record", "StageTimes", "span", "sync", "recording",
           "record", "clear", "count", "MAX_ROUNDS", "MAX_LOOSE", "ROUND",
           "DECODE", "SYNC", "SYNC_WARNING", "COUNTERS", "COUNTED"]

#: rounds the record keeps (oldest dropped first)
MAX_ROUNDS = 64
#: spans outside any round the record keeps
MAX_LOOSE = 4096
#: the span that opens a round, the span around a field of view's decode
#: and the span of a host wait
ROUND, DECODE, SYNC = "round", "decode", "sync"
#: the spans that count the host's waits on the card and the counters
COUNTED = (ROUND, DECODE)
#: the text of torch's warning at a synchronising call under
#: ``torch.cuda.set_sync_debug_mode("warn")``
SYNC_WARNING = "called a synchronizing CUDA operation"
#: the process's counters (:func:`count`), each a recorded round's
#: attribute of the same name
COUNTERS = ("const_builds",)

_profiler_enabled = torch.autograd._profiler_enabled


class _Recorder:
    """What is recorded, for the whole process (as the profiler's record
    is)."""

    def __init__(self):
        self.forced = 0
        self.lock = threading.Lock()
        self.rounds: Deque[List["Span"]] = deque(maxlen=MAX_ROUNDS)
        self.loose: Deque["Span"] = deque(maxlen=MAX_LOOSE)
        self.round_ids = itertools.count()
        self.local = threading.local()
        self.counts = dict.fromkeys(COUNTERS, 0)

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st


_REC = _Recorder()


class _NoSpan:
    """The span that records nothing (recording off)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NO_SPAN = _NoSpan()


class _SyncCount:
    """The host's waits on the card while a recorded round is open (see
    the module's docstring)."""

    def __init__(self):
        self.n = self.unmarked = 0
        self._mode: Optional[int] = None

    def __enter__(self) -> "_SyncCount":
        self._saved = warnings.catch_warnings()
        self._saved.__enter__()
        self._show = warnings.showwarning
        warnings.filterwarnings("always", message=SYNC_WARNING)
        warnings.showwarning = self._count
        if torch.cuda.is_initialized():
            self._mode = torch.cuda.get_sync_debug_mode()
            if self._mode == 0:
                torch.cuda.set_sync_debug_mode("warn")
        return self

    def _count(self, message, category, *args, **kwargs):
        if str(message).startswith(SYNC_WARNING):
            self.n += 1
            stack = _REC.stack()
            if not stack or stack[-1].name != SYNC:
                self.unmarked += 1
            # an enclosing counted span counts it too, and decides whether
            # it is shown
            outer = getattr(self._show, "__self__", None)
            if not self._mode and not isinstance(outer, _SyncCount):
                return
        self._show(message, category, *args, **kwargs)

    def __exit__(self, *exc) -> bool:
        if self._mode == 0:
            torch.cuda.set_sync_debug_mode(0)
        self._saved.__exit__(*exc)
        return False


class Span:
    """One recorded span (see the module's docstring).  `parent` is the
    enclosing Span (None at the top), `round` the id of the round it
    belongs to (None outside a round)."""

    __slots__ = ("name", "attrs", "parent", "round", "start_ns", "end_ns",
                 "_events", "_device_ms", "_group", "_syncs", "_counts")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name, self.attrs = name, attrs
        self.parent: Optional[Span] = None
        self.round: Optional[int] = None
        self.start_ns = self.end_ns = 0
        self._events = None
        self._device_ms: Optional[float] = None
        self._group: Optional[list] = None
        self._syncs: Optional[_SyncCount] = None
        self._counts: Optional[Dict[str, int]] = None

    def __enter__(self) -> "Span":
        stack = _REC.stack()
        parent = stack[-1] if stack else None
        self.parent = parent
        if self.name in COUNTED:
            self._syncs = _SyncCount().__enter__()
            self._counts = dict(_REC.counts)
        if self.name == ROUND:
            self.round = next(_REC.round_ids)
            self._group = []
            _REC.rounds.append(self._group)
        elif parent is not None:
            self.round, self._group = parent.round, parent._group
        if self._group is not None:
            self._group.append(self)
        else:
            _REC.loose.append(self)
        if self.name != SYNC and torch.cuda.is_initialized():
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            self._events = ev
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        if self._events is not None:
            self._events[1].record()
        _REC.stack().pop()
        if self._syncs is not None:
            self._syncs.__exit__(*exc)
            self.attrs["syncs"] = self._syncs.n
            self.attrs["unmarked_syncs"] = self._syncs.unmarked
            self._syncs = None
            for name, n in _REC.counts.items():
                self.attrs[name] = n - self._counts[name]
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only once the span's work has run."""
        self.attrs.update(attrs)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        """The span's event interval in ms (None without CUDA events).
        Resolved on first read, after waiting for the span's end event."""
        if self._device_ms is None and self._events is not None:
            start, end = self._events
            end.synchronize()
            self._device_ms = float(start.elapsed_time(end))
            self._events = None
        return self._device_ms

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, round={self.round}, "
                f"host_ms={self.host_ms:.3f}, attrs={self.attrs})")


def span(name: str, **attrs):
    """A span named `name` (a context manager; ``as`` gives the Span, or
    the shared no-op when recording is off).  ``span(ROUND)`` opens a new
    round, and is a no-op inside one (a round's call of another round's
    code is part of it)."""
    if _REC.forced > 0 or _profiler_enabled():
        if name == ROUND:
            stack = _REC.stack()
            if stack and stack[-1].round is not None:
                return _NO_SPAN
        return Span(name, attrs)
    return _NO_SPAN


def sync(site: str):
    """A span around a point where the host waits for the card, named
    `site`."""
    if _REC.forced > 0 or _profiler_enabled():
        return Span(SYNC, {"site": site})
    return _NO_SPAN


def count(name: str) -> None:
    """Add one to the counter `name` (one of :data:`COUNTERS`), recording
    or not."""
    with _REC.lock:
        _REC.counts[name] += 1


@contextlib.contextmanager
def recording():
    """Record spans inside the block, profiler or not."""
    with _REC.lock:
        _REC.forced += 1
    try:
        yield
    finally:
        with _REC.lock:
            _REC.forced -= 1


class Record(NamedTuple):
    """A copy of the record: `rounds`, oldest first, each the round's spans
    in the order they opened (the ``round`` span first); `loose`, the spans
    outside any round."""

    rounds: List[List[Span]]
    loose: List[Span]


def record() -> Record:
    """The record as it stands.  Read device intervals after the work they
    time has been issued; reading waits for it."""
    return Record([list(g) for g in _REC.rounds], list(_REC.loose))


def clear() -> None:
    """Forget everything recorded."""
    _REC.rounds.clear()
    _REC.loose.clear()


@dataclass
class StageTimes:
    """Structured per-stage timing record (replaces the reference's
    `verbose` wall-time prints): one ``{"stage", "seconds", **extra}``
    dict a stage, on the host clock."""

    records: List[Dict] = field(default_factory=list)

    def add(self, stage: str, seconds: float, **extra):
        self.records.append({"stage": stage, "seconds": float(seconds),
                             **extra})

    @contextlib.contextmanager
    def stage(self, name: str, **extra):
        """Time the block as stage `name` on the host clock.  Yields the
        stage's dict, to which the caller may add seconds spent on the
        stage elsewhere (a later wait for its device work)."""
        rec = {"stage": name, "seconds": 0.0, **extra}
        t0 = time.perf_counter()
        yield rec
        rec["seconds"] += time.perf_counter() - t0
        self.records.append(rec)

    def total(self, stage: Optional[str] = None) -> float:
        return sum(r["seconds"] for r in self.records
                   if stage is None or r["stage"] == stage)

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for r in self.records:
            out[r["stage"]] = out.get(r["stage"], 0.0) + r["seconds"]
        return out
