"""The host-side self time of the per-query metadata lists (``serving.meta``)
a call of the traced window, in ms."""

from perfbench import progspans


def read(run):
    return progspans.host_ms(run, "serving.meta")
