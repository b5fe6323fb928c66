"""The card-side self time of the resize to the tower's input
(``features.resize``) a batch of the traced window, in ms."""

from perfbench import progspans


def read(run):
    return progspans.card_ms(run, "features.resize")
