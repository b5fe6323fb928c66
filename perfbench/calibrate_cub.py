"""The readings the limits of the CUB cell's ``correct`` are set from, on
the card, and the faults planted under its timed path:

    python3 perfbench/calibrate_cub.py --seeds 1,2,3 --seconds 3 \\
        [--control] [--faults unchanged,half_batch,altered,flipped]

For each seed, as ``perfbench/calibrate.py`` makes them: the program's
readings (set-up, a short window, the comparison with the plain
reference), with ``--control`` the reference put in the program's place at
TF32, with ``--faults`` the program with each fault planted (the reference
then follows the control's, or the faulty run's, own states).  One JSON line
a seed and mode on standard output.  The benchmark's own runs never run
this.

Faults (``plant(fault)`` patches the program in this process and returns
the function that takes the patch out again): ``unchanged`` (the optimizer
step left out), ``half_batch`` (the loss over the first half of the batch),
``altered`` (each batch norm moves its running variance towards the
unbiased batch variance, n / (n - 1) of the biased one, as slim's fused
batch norm does) and ``flipped`` (the optimizer's change of every
parameter taken with the wrong sign: losses, the first gradient and the
statistics stay the program's, the change keeps its size)."""

import argparse
import json
import os
import sys
import time
from typing import Callable

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from perfbench import calibrate, harness  # noqa: E402

WORKLOAD = "cub_inception_v2.train_e2e"
FAULTS = ("unchanged", "half_batch", "altered", "flipped")


def plant(fault: str) -> Callable[[], None]:
    import torch
    from multimodal_similarity_tpu_torch.models import inception_v2
    from multimodal_similarity_tpu_torch.train.trainers import base_CUB
    if fault == "unchanged":
        obj, name, new = base_CUB, "apply_gradients", lambda opt, lr: None
    elif fault == "half_batch":
        make = base_CUB.make_cub_loss

        def halved(cfg, loss_kind):
            loss = make(cfg, loss_kind)
            return lambda emb, labels: loss(emb[:emb.shape[0] // 2],
                                            labels[:labels.shape[0] // 2])
        obj, name, new = base_CUB, "make_cub_loss", halved
    elif fault == "altered":
        forward = inception_v2.BatchNorm.forward

        def unbiased(self, x):
            out = forward(self, x)
            if self.training:
                with torch.no_grad():
                    mean = x.mean(dim=(0, 2, 3))
                    var = torch.clamp((x * x).mean(dim=(0, 2, 3))
                                      - mean * mean, min=0.0)
                    n = x.numel() // x.shape[1]
                    self.running_var.add_((1.0 - self.momentum) * var
                                          / (n - 1))
            return out
        obj, name, new = inception_v2.BatchNorm, "forward", unbiased
    elif fault == "flipped":
        step = base_CUB.apply_gradients

        def flipped(opt, lr):
            params = [p for g in opt.param_groups for p in g["params"]]
            before = [p.detach().clone() for p in params]
            step(opt, lr)
            with torch.no_grad():
                for p, b in zip(params, before):
                    p.copy_(2.0 * b - p)
        obj, name, new = base_CUB, "apply_gradients", flipped
    else:
        raise ValueError(f"no fault {fault!r}; expected one of {FAULTS}")
    old = getattr(obj, name)
    setattr(obj, name, new)
    return lambda: setattr(obj, name, old)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", default="")
    args = p.parse_args(argv)
    harness._setup_environment()
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(WORKLOAD)

    def emit(seed, mode, readings, t0):
        print(json.dumps({"workload": WORKLOAD, "seed": seed, "mode": mode,
                          "readings": readings,
                          "s": round(time.time() - t0, 1)}), flush=True)

    for seed in (int(s) for s in args.seeds.split(",")):
        refs = {}
        t0 = time.time()
        with calibrate._stdout_to_stderr():
            readings, got, run = calibrate.program_readings(
                cell, seed, args.seconds, "cuda", refs)
        emit(seed, "program", readings, t0)
        if args.control:
            t0 = time.time()
            with calibrate._stdout_to_stderr():
                ctrl = cell.kind.control(run, got)
                readings = cell.kind.compare(
                    run, ctrl, cell.kind.reference(run, ctrl))
            emit(seed, "control", readings, t0)
        del got
        for fault in (f for f in args.faults.split(",") if f):
            remove = plant(fault)
            t0 = time.time()
            try:
                # the reference follows the faulty run's own states
                with calibrate._stdout_to_stderr():
                    readings, _, _ = calibrate.program_readings(
                        cell, seed, args.seconds, "cuda", {})
            finally:
                remove()
            emit(seed, f"fault:{fault}", readings, t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
