"""drift_span_ms: the event interval of a round's `drift` span
(``FovPipeline.drift_of``), from the program's spans of the traced
window; median over its rounds; ms a round."""

from ..harness import spans


def read(run):
    return spans.round_device_ms("drift")
