"""The card-side self time of the PDDM rows of the sampled anchors
(``mm.pddm``) a step of the traced window, in ms."""

from perfbench import progspans


def read(run):
    return progspans.card_ms(run, "mm.pddm")
