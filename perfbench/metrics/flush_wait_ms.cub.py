"""The host-side self time of the readback and log of the step's scalars
(``cub.log``), waiting for the card included, a step of the traced window,
in ms."""

from perfbench import progspans


def read(run):
    return progspans.host_ms(run, "cub.log")
