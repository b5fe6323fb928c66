"""How far the card trails the host at the end of a step: the mean over
the traced window's steps of the card's time at ``trainer.step``'s exit
boundary less the host's, in ms.  About 0 when the card waits on the
host."""

from perfbench import progspans


def read(run):
    return progspans.exit_lag_ms(run, "trainer.step")
