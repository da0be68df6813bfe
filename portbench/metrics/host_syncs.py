"""host_syncs: the times a round's host code waits on the card, as the
program's `round` span counts them (the synchronising calls torch's sync
debug mode reports while the round is open), in the traced window; median
over its rounds; waits a round."""

from ..harness import spans


def read(run):
    return spans.host_syncs()
