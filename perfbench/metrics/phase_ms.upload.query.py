"""The card-side self time of the query rows' upload (``serving.upload``) a
call of the traced window, in ms."""

from perfbench import progspans


def read(run):
    return progspans.card_ms(run, "serving.upload")
