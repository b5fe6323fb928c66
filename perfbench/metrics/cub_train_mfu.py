"""The CUB step's model FLOPs (the reference's count from the tower's
convolution shapes, ``perfbench/reference/cub_inception_v2.py``
``step_flops``) x the measured window's steps over the window, as a share
of the card's TF32 peak, in percent."""

from perfbench import flops
from perfbench.reference import cub_inception_v2 as ref


def read(run):
    steps = run.counters.get("steps")
    if not steps or not run.window_s:
        return None
    c = run.config
    rate = (ref.step_flops(max(c["batch_size"], 32), c["crop"],
                           c["emb_dim"]) * steps / run.window_s)
    return 100.0 * rate / flops.PEAK_FLOPS
