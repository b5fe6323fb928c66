"""The readings the limits of ``correct`` are set from, on the card:

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        --seconds 3 [--control] [--faults half_batch,altered]

For each seed: set-up, a short window at the cell's own load and size,
and the comparison with the plain reference, as a run makes them (the
program's readings, the lower end of a limit); with ``--control`` the
reference put in the program's place at TF32 (the control's readings,
the upper end); with ``--faults`` the program with each fault of
``perfbench/faults.py`` planted.  One JSON line a seed and mode on
standard output.  The benchmark's own runs never run this."""

import argparse
import json
import os
import shutil
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from perfbench import faults, harness  # noqa: E402


def program_readings(cell, seed, seconds, device, ref_cache):
    """(readings, outputs, run) of one run of the program."""
    import torch
    kind = cell.kind
    run = harness.Run(cell=cell, seed=seed, device=torch.device(device))
    state = kind.setup(run)
    kind.window(state, seconds)
    got = kind.outputs(state)
    kind.release(state)
    del state
    if device == "cuda":
        torch.cuda.empty_cache()
    if seed not in ref_cache:
        ref_cache[seed] = kind.reference(run, got)
    return kind.compare(run, got, ref_cache[seed]), got, run


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", default="")
    args = p.parse_args(argv)
    harness._setup_environment()
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(args.workload)
    kind = cell.traffic["kind"]
    seeds = [int(s) for s in args.seeds.split(",")]
    fault_list = [f for f in args.faults.split(",") if f]

    def emit(rec):
        print(json.dumps(rec), flush=True)

    for seed in seeds:
        refs = {}
        t0 = time.time()
        with _stdout_to_stderr():
            readings, got, run = program_readings(cell, seed, args.seconds,
                                                  "cuda", refs)
        emit({"workload": args.workload, "seed": seed, "mode": "program",
              "readings": readings, "s": round(time.time() - t0, 1)})
        if args.control:
            t0 = time.time()
            with _stdout_to_stderr():
                ctrl = cell.kind.control(run, got)
                readings = cell.kind.compare(run, ctrl, refs[seed])
            emit({"workload": args.workload, "seed": seed, "mode": "control",
                  "readings": readings, "s": round(time.time() - t0, 1)})
        _drop(got)
        for fault in fault_list:
            remove = faults.plant(kind, fault)
            t0 = time.time()
            try:
                with _stdout_to_stderr():
                    readings, fgot, _ = program_readings(
                        cell, seed, args.seconds, "cuda", refs)
            finally:
                remove()
            _drop(fgot)
            emit({"workload": args.workload, "seed": seed,
                  "mode": f"fault:{fault}", "readings": readings,
                  "s": round(time.time() - t0, 1)})
        refs.clear()
    return 0


def _drop(got):
    """A training run's data directory, once compared."""
    if isinstance(got, dict) and "root" in got:
        shutil.rmtree(got["root"], ignore_errors=True)


def _stdout_to_stderr():
    import contextlib
    return contextlib.redirect_stdout(sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
