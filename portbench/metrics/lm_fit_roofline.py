"""lm_fit_roofline: the least time of the traced span's ``lm_fit``
launches, summed over their launch shapes (one round-0 launch a channel
fit, the rest refits; roofline/lm_fit.py), over their device time in the
trace; % of the published peaks."""


def read(run):
    t = run.trace
    if t is None:
        return None
    n, sec = t.kernel(r"lm_fit\w*_kernel")
    if not n or sec <= 0:
        return None
    fits = t.counts["fits"]
    return 100.0 * run.roofline("lm_fit").least(run.config, run.peaks,
                                                fits, n) / sec
