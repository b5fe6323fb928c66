"""The card-side self time of the backward pass (``cub.backward``) a step of
the traced window, in ms."""

from perfbench import progspans


def read(run):
    return progspans.card_ms(run, "cub.backward")
