"""The card-side self time of the optimizer's update, the tower's 0.1
gradient scale included (``cub.optimizer``), a step of the traced window,
in ms."""

from perfbench import progspans


def read(run):
    return progspans.card_ms(run, "cub.optimizer")
