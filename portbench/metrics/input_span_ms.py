"""input_span_ms: the event interval of a round's `input` span (the
upload of the raw frame window and its de-interleave in
``FovPipeline.process_round_raw``), from the program's spans of the traced
window; median over its rounds; ms a round."""

from ..harness import spans


def read(run):
    return spans.round_device_ms("input")
