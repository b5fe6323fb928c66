"""The card's idle share over the CUB cell's measured window, in percent:
1 - the card's busy time a step of the traced window x the measured
window's steps over its length (``devtrace.idle_share``)."""

from perfbench.devtrace import idle_share


def read(run):
    return idle_share(run)
