"""device_idle_pct: the share of the traced span of whole units (host
clock, ending in a synchronisation) in which no kernel, copy or memset
ran on the card; %."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
