"""The card-side self time of the device cache's gather (``cache.gather``) a
step of the traced window, in ms."""

from perfbench import progspans


def read(run):
    return progspans.card_ms(run, "cache.gather")
