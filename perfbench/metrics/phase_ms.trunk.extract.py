"""The card-side self time of the tower's trunk (``features.trunk``) a batch
of the traced window, in ms."""

from perfbench import progspans


def read(run):
    return progspans.card_ms(run, "features.trunk")
