"""drift_ms: ``FovPipeline.drift_of`` of a pool round's corrected drift
channel against the prepared reference, host clock around work ending in
a synchronisation, median over the rounds timed apart; ms a round."""

import statistics


def read(run):
    v = run.stages.get("drift")
    return 1e3 * statistics.median(v) if v else None
