"""refit_rounds: the Jacobi refit rounds a channel's fit ran (`refit`
spans over `fit` spans), from the program's spans of the traced window;
mean over its channels; rounds a channel."""

from ..harness import spans


def read(run):
    return spans.refit_rounds()
