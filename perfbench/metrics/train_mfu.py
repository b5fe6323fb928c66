"""The flagship step's model FLOPs over the measured window's time a step,
as a share of the card's TF32 peak, in percent."""

from perfbench import flops


def read(run):
    steps = run.counters.get("steps")
    if not steps or not run.window_s:
        return None
    rate = flops.flagship_step(run.config) * steps / run.window_s
    return 100.0 * rate / flops.PEAK_FLOPS
