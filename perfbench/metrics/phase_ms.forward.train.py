"""The card-side self time of the mined rows' gather and dequantization
(``mm.take``) and the train-mode re-forward and losses
(``mm.forward_loss``) a step of the traced window, in ms."""

from perfbench import progspans


def read(run):
    return progspans.card_ms(run, "mm.take", "mm.forward_loss")
