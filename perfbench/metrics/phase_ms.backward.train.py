"""The card-side self time of the backward pass (``mm.backward``) a step of
the traced window, in ms."""

from perfbench import progspans


def read(run):
    return progspans.card_ms(run, "mm.backward")
