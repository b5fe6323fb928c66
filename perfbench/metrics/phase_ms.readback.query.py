"""The card-side self time of the results' readback (``serving.readback``) a
call of the traced window, in ms."""

from perfbench import progspans


def read(run):
    return progspans.card_ms(run, "serving.readback")
