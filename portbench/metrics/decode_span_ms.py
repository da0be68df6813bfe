"""decode_span_ms: the event interval of the program's `decode` span (a
field of view's candidate spots decoded into spot groups and homolog
traces, outside any round) in the traced window; median over its decodes;
ms a FOV."""

from ..harness import decode_spans


def read(run):
    return decode_spans.decode_device_ms()
