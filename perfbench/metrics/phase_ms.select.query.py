"""The card-side self time of the top-k selections and merges, every chunk's
(``topk.select``) a call of the traced window, in ms."""

from perfbench import progspans


def read(run):
    return progspans.card_ms(run, "topk.select")
