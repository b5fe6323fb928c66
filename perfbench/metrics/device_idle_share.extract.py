"""The card's idle share over the traced window, in percent: 1 - the union
of its operations' intervals over the window's length."""

from perfbench.devtrace import idle_share


def read(run):
    return idle_share(run)
