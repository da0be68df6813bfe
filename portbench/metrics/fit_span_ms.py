"""fit_span_ms: the event interval of a channel's `fit` span (its
seeding, LM fit and coordinate warp), from the program's spans of the
traced window; median over its channels; ms a channel."""

from ..harness import spans


def read(run):
    return spans.span_device_ms("fit")
