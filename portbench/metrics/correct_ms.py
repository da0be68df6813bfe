"""correct_ms: the corrections of every channel of a pool round
(``FovPipeline.correct_one`` each), host clock around work ending in a
synchronisation, median over the rounds timed apart; ms a round."""

import statistics


def read(run):
    v = run.stages.get("correct")
    return 1e3 * statistics.median(v) if v else None
