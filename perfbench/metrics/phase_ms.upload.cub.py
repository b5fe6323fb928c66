"""The card-side self time of the batch's upload (``cub.upload``) a step of
the traced window, in ms."""

from perfbench import progspans


def read(run):
    return progspans.card_ms(run, "cub.upload")
