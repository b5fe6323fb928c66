"""The card-side self time of the features' layout change and readback
(``features.readback``) a batch of the traced window, in ms."""

from perfbench import progspans


def read(run):
    return progspans.card_ms(run, "features.readback")
