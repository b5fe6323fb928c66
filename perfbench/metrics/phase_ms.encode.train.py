"""The card-side self time of the flagship's encoders: the core's eval-mode
embedding of the budget (``mm.embed``) and the sensors and segment branches
(``mm.branches``) a step of the traced window, in ms."""

from perfbench import progspans


def read(run):
    return progspans.card_ms(run, "mm.embed", "mm.branches")
