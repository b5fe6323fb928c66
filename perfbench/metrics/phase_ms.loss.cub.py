"""The card-side self time of the random crops (``cub.crop``) and of the
head, the normalisation and the semi-hard loss (``cub.loss``) a step of the
traced window, in ms."""

from perfbench import progspans


def read(run):
    return progspans.card_ms(run, "cub.crop", "cub.loss")
