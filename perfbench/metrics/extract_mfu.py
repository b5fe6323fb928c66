"""The trunk's convolution FLOPs of every frame of the measured window
over the window, as a share of the card's TF32 peak, in percent."""

from perfbench import flops


def read(run):
    frames = run.counters.get("frames")
    if not frames or not run.window_s:
        return None
    rate = flops.trunk_frame(run.config["image_size"]) * frames / run.window_s
    return 100.0 * rate / flops.PEAK_FLOPS
