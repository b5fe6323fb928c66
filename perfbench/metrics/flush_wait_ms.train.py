"""The host-side self time of the deferred readback of the steps' scalars
(``trainer.flush``), waiting for the card included, a step of the traced
window, in ms."""

from perfbench import progspans


def read(run):
    return progspans.host_ms(run, "trainer.flush")
