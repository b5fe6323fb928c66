"""The card-side self time of the optimizer's update (``mm.optimizer``) a step
of the traced window, in ms."""

from perfbench import progspans


def read(run):
    return progspans.card_ms(run, "mm.optimizer")
