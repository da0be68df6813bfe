"""correct_span_ms: the event intervals of a round's `correct` spans
(each channel's ``FovPipeline.correct_one``), summed, from the program's
spans of the traced window; median over its rounds; ms a round."""

from ..harness import spans


def read(run):
    return spans.round_device_ms("correct")
