"""h2d_ms: device time of the host-to-device copies in the traced span,
over the rounds in it; ms a round."""


def read(run):
    t = run.trace
    if t is None or not t.h2d_count:
        return None
    return 1e3 * t.h2d_s / t.counts["rounds"]
