"""The program's own spans of the traced window, for the per-layer readers.

The program (``imageanalysis3_tpu_torch.tracing``) records spans while the
profiler runs, so after a traced run its record holds the window's rounds
and nothing else: a ``round`` span a round, with its ``input``,
``correct``, ``drift`` and ``fit`` spans, each fit's ``seed`` and
``refit`` spans, and a ``sync`` span wherever the round's host code waits
for the card.  The round span counts the host's waits on the card itself
(attribute ``syncs``, from torch's sync debug mode).

A span's event interval is the time between two CUDA events on the stream
at its entry and exit: the time from the card reaching the span's work to
its end, launch gaps included.  The round is host-bound, and under the
profiler the host launches slower still, so these intervals follow the
host's pace as much as the kernels' time; a span's host interval comes
from the host clock, profiler cost included.

A program without the recorder gives None, as does a record with nothing to
read (a run not traced, or on the CPU, where spans have no event
interval): the readers then report nothing.
"""

from __future__ import annotations

import statistics
from typing import List, Optional


def window_rounds() -> Optional[List[list]]:
    """The recorded rounds, each its list of spans (round span first)."""
    try:
        from imageanalysis3_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.record().rounds or None


def _median(values) -> Optional[float]:
    values = [v for v in values if v is not None]
    return statistics.median(values) if values else None


def round_device_ms(name: str) -> Optional[float]:
    """Median over the rounds of the summed event intervals of a round's
    `name` spans (rounds without one left out); ms a round."""
    out = []
    for spans in window_rounds() or ():
        ms = [s.device_ms for s in spans if s.name == name]
        out.append(sum(ms) if ms and None not in ms else None)
    return _median(out)


def span_device_ms(name: str) -> Optional[float]:
    """Median over every `name` span of its event interval; ms a span."""
    return _median(s.device_ms for spans in window_rounds() or ()
                   for s in spans if s.name == name)


def host_own_ms() -> Optional[float]:
    """Median over the rounds of the round span's host duration less the
    host durations of its sync spans; ms a round."""
    return _median(
        spans[0].host_ms - sum(s.host_ms for s in spans if s.name == "sync")
        for spans in window_rounds() or ())


def host_syncs() -> Optional[float]:
    """Median over the rounds of the host's waits on the card that the
    round counted; waits a round."""
    return _median(spans[0].attrs.get("syncs")
                   for spans in window_rounds() or ())


def refit_rounds() -> Optional[float]:
    """Jacobi refit rounds a channel's fit ran, over every fit of the
    window: refit spans over fit spans."""
    fits = refits = 0
    for spans in window_rounds() or ():
        fits += sum(s.name == "fit" for s in spans)
        refits += sum(s.name == "refit" for s in spans)
    return refits / fits if fits else None
