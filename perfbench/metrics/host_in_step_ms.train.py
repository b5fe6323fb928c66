"""The host's time inside the fused-step calls a step, in ms (host clock
around each call of the measured window)."""


def read(run):
    steps = run.counters.get("steps")
    if not steps or "host_in_step_s" not in run.counters:
        return None
    return 1e3 * run.counters["host_in_step_s"] / steps
