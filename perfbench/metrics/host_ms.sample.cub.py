"""The host-side self time of the class-balanced draw and the gather of the
batch from the host f32 images (``cub.sample``) a step of the traced
window, in ms."""

from perfbench import progspans


def read(run):
    return progspans.host_ms(run, "cub.sample")
