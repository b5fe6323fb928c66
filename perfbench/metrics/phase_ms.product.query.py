"""The card-side self time of the distance products, every gallery chunk's
(``topk.product``) a call of the traced window, in ms."""

from perfbench import progspans


def read(run):
    return progspans.card_ms(run, "topk.product")
