"""host_own_ms: the host's own time in a round: the `round` span's host
duration less the host durations of its `sync` spans (the host waiting on
the card), from the program's spans of the traced window; median over its
rounds; ms a round."""

from ..harness import spans


def read(run):
    return spans.host_own_ms()
