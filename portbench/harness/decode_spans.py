"""The program's decode spans of the traced window, for the per-layer
readers.

The program (``imageanalysis3_tpu_torch.tracing``) records a ``decode``
span around each field of view's ``DNAMerfishDecoder.decode`` while the
profiler runs; the decode runs in no round, so its spans sit among the
record's spans outside any round.  The span counts the decode's own waits
on the card (attribute ``syncs``, from torch's sync debug mode), as a
round span counts its own.  Its event interval is the time between two
CUDA events on the stream at its entry and exit.

A program without decode spans gives None, as does a record with nothing
to read (a run not traced, or on the CPU, where spans have no event
interval): the readers then report nothing.
"""

from __future__ import annotations

import statistics
from typing import List, Optional


def decode_spans() -> List:
    try:
        from imageanalysis3_tpu_torch import tracing
    except ImportError:
        return []
    return [s for s in tracing.record().loose if s.name == "decode"]


def _median(values) -> Optional[float]:
    values = [v for v in values if v is not None]
    return statistics.median(values) if values else None


def decode_device_ms() -> Optional[float]:
    """Median over the decode spans of their event intervals; ms a FOV."""
    return _median(s.device_ms for s in decode_spans())


def decode_syncs() -> Optional[float]:
    """Median over the decode spans of the waits on the card each
    counted; waits a FOV."""
    return _median(s.attrs.get("syncs") for s in decode_spans())
