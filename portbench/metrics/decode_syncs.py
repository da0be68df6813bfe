"""decode_syncs: the times a field of view's decode waits on the card, as
the program's `decode` span counts them (the synchronising calls torch's
sync debug mode reports while it is open), in the traced window; median
over its decodes; waits a FOV."""

from ..harness import decode_spans


def read(run):
    return decode_spans.decode_syncs()
