"""fit_ms: ``FovPipeline.fit_channel`` (seeding and the LM fit) of one
corrected data channel, host clock around work ending in a
synchronisation, median over the channels timed apart; ms a channel."""

import statistics


def read(run):
    v = run.stages.get("fit")
    return 1e3 * statistics.median(v) if v else None
