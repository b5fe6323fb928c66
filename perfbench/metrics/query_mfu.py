"""2 Q N d a query call over the mean call time of the measured window, as a
share of the card's TF32 peak, in percent."""

from perfbench import flops


def read(run):
    calls = run.counters.get("calls")
    if not calls or not run.window_s:
        return None
    rate = flops.retrieval_call(run.config, run.params) * calls / run.window_s
    return 100.0 * rate / flops.PEAK_FLOPS
