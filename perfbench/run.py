"""Run one cell of the benchmark once and print its result as the last line
of standard output:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout; see perfbench/README.md."""

import os
import sys
import time

T_START = time.perf_counter()

# the checkout's root in place of this directory: the program and the
# ``perfbench`` package import from there
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
