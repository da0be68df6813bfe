"""seed_classify_roofline: the least time of the traced span's
``seed_classify`` launches (each at the configuration's shape,
roofline/seed_classify.py) over their device time in the trace; % of the
published peaks."""


def read(run):
    t = run.trace
    if t is None:
        return None
    n, sec = t.kernel(r"seed_classify\w*_kernel")
    if not n or sec <= 0:
        return None
    return 100.0 * n * run.roofline("seed_classify").least(
        run.config, run.peaks)[0] / sec
