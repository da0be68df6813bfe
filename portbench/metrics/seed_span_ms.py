"""seed_span_ms: the event interval of a channel's `seed` span
(``get_seeds`` in ``FovPipeline.fit_channel``), from the program's spans of
the traced window; median over its channels; ms a channel."""

from ..harness import spans


def read(run):
    return spans.span_device_ms("seed")
