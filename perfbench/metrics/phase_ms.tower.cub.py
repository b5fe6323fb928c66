"""The card-side self time of the InceptionV2 tower's training-mode forward
(``cub.tower``) a step of the traced window, in ms."""

from perfbench import progspans


def read(run):
    return progspans.card_ms(run, "cub.tower")
