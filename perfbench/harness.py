"""The benchmark's harness: finds a cell by name, runs it once, prints one
JSON line.

Everything a cell needs is found by name from files of its own:

* ``BENCHMARK.json`` (the repository root) lists the cells, the
  configurations and the metrics;
* ``perfbench/configs/<config>.json`` holds a configuration as it is run;
* ``perfbench/traffic/<traffic>.json`` holds a traffic mix: the kind of
  traffic it is (``"kind"``), its parameters, and the limits of its output
  check (``"limits"``);
* ``perfbench/kinds/<kind>.py`` is the one general code of a kind of
  traffic: ``setup(run)``, ``window(state, seconds)``, ``outputs(state)``,
  ``release(state)``, then ``reference(run, got)``, ``compare(run, got,
  want)`` and, for the calibration of the limits, ``control(run, got)``
  (the reference in the program's place at the precision below the one
  the configuration states);
* ``perfbench/metrics/<metric>.py`` reads one per-layer metric from a
  traced run (``read(run)``, None where it finds nothing to read).

A later cell, configuration, traffic mix or metric is added by adding such
files and entries; no file here changes.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# modules that may not be loaded in the process that prints a result
FORBIDDEN = ("jax", "jaxlib", "flax", "multimodal_similarity_tpu")

# the traced run's window, where --seconds is longer: a trace's size, and
# the time to read it, grow with the window
TRACED_WINDOW_S = 5.0

# exit codes
EXIT_NO_CARD, EXIT_FORBIDDEN, EXIT_SPEC = 2, 3, 4


class SpecError(ValueError):
    """A cell, configuration, traffic mix or metric that cannot be found."""


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise SpecError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of BENCHMARK.json with everything found by its names."""

    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]
    kind: Any
    bench_root: str

    @property
    def params(self) -> dict:
        return self.traffic.get("params", {})

    @property
    def limits(self) -> dict:
        return self.traffic.get("limits", {})


def load_cell(name: str, bench_root: str = ROOT) -> Cell:
    """The cell ``name`` of ``<bench_root>/BENCHMARK.json``, its files
    under ``<bench_root>/perfbench``."""
    spec = _read_json(os.path.join(bench_root, "BENCHMARK.json"))
    pb = os.path.join(bench_root, "perfbench")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json "
                        f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"workload {name!r} names no configuration "
                        f"{w['config']!r}")
    config = _read_json(os.path.join(bench_root,
                                     configs[w["config"]]["file"]))
    traffic = _read_json(os.path.join(pb, "traffic", w["traffic"] + ".json"))
    kind = load_module(os.path.join(pb, "kinds", traffic["kind"] + ".py"),
                       f"perfbench_kind_{traffic['kind']}")
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    per_layer = [m for m in spec["per_layer"] if name in m["workloads"]]
    return Cell(name=name, config_name=w["config"], config=config,
                traffic_name=w["traffic"], traffic=traffic,
                chips=int(w["chips"]), end_to_end=e2e, per_layer=per_layer,
                kind=kind, bench_root=bench_root)


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------

class Spans:
    """The benchmark's spans around its calls into the program: while a
    trace runs each call's (start, end, name) on the host's clock is kept,
    so the trace's idle gaps can be told by the call they fell in;
    otherwise nothing."""

    def __init__(self):
        self.kept = None

    def start(self) -> None:
        self.kept = []

    def stop(self) -> list:
        kept, self.kept = self.kept, None
        return kept

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.kept is None:
            yield
            return
        t = time.perf_counter()
        try:
            yield
        finally:
            self.kept.append((t, time.perf_counter(), name))


@dataclass
class Run:
    """What one run of a cell knows; metric readers read it.  The traffic's
    kind fills ``counters`` and ``window_s`` (host clock) from the measured
    window; in a traced run ``trace`` holds the traced window's reduction
    (``window_s``, ``busy_s``, ``device_ops``, ``idle_gaps``,
    ``n_device_events``) and its own ``counters``."""

    cell: Cell
    seed: int
    device: Any
    spans: Spans = field(default_factory=Spans)
    counters: Dict[str, float] = field(default_factory=dict)
    window_s: Optional[float] = None
    trace: Optional[dict] = None

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def params(self) -> dict:
        return self.cell.params

    def log(self, msg: str) -> None:
        print(f"[{self.cell.name}] {msg}", file=sys.stderr, flush=True)

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)


class Reservoir:
    """``n`` of a window's answers drawn uniformly from the seed's stream,
    for answers too many to keep: ``add(item)`` each in turn."""

    def __init__(self, n: int, seed: int):
        import numpy as np
        self.n, self.seen, self.items = n, 0, []
        self.rng = np.random.RandomState(seed)

    def add(self, item) -> None:
        if len(self.items) < self.n:
            self.items.append(item)
        else:
            j = self.rng.randint(self.seen + 1)
            if j < self.n:
                self.items[j] = item
        self.seen += 1


def sub_seed(seed: int, k: int) -> int:
    """The ``k``-th 31-bit seed derived from a run's ``--seed`` (any whole
    number): what seeds the program's generators and the benchmark's
    own."""
    import numpy as np
    seed = int(seed)
    words = np.random.SeedSequence([abs(seed), int(seed < 0)]
                                   ).generate_state(k + 1)
    return int(words[k] & 0x7FFFFFFF)


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def judge(readings: Dict[str, float], limits: Dict[str, float]) -> dict:
    """Each compared number beside its limit, and whether all hold.  A
    number with no limit, or one that is not finite, fails."""
    out = {}
    ok = True
    for name, value in readings.items():
        limit = limits.get(name)
        held = (limit is not None and value is not None
                and math.isfinite(value) and value <= limit)
        ok = ok and held
        out[name] = {"value": value, "limit": limit}
    return {"correct": ok and bool(readings), "checks": out}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None
             ) -> dict:
    """Set up, warm, measure for ``seconds``, then check the outputs
    against the plain reference.  Returns the result object (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` with
    ``trace``, and ``checks`` last).  With ``trace`` the measured window
    is followed by a traced one of at most ``TRACED_WINDOW_S``: the
    per-layer metrics on the host's clock read the measured window, those
    of the card the traced one.  ``device`` is ``cuda`` for a measurement;
    the CPU serves the harness's own tests."""
    import torch

    from perfbench import devtrace

    t_start = time.perf_counter() if t_start is None else t_start
    run = Run(cell=cell, seed=int(seed), device=torch.device(device))
    kind = cell.kind
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    state = kind.setup(run)
    run.synchronize()
    setup_s = time.perf_counter() - t_start
    run.log(f"set-up {setup_s:.3f} s")
    values = kind.window(state, seconds)
    values["setup_s"] = setup_s
    if trace:
        measured = (dict(run.counters), run.window_s)
        run.counters.clear()
        with devtrace.DeviceTrace(run) as tr:
            kind.window(state, min(seconds, TRACED_WINDOW_S))
        run.trace = dict(tr.reduce(), counters=dict(run.counters))
        run.counters, run.window_s = measured
    peak = (int(torch.cuda.max_memory_allocated(run.device))
            if run.device.type == "cuda" else 0)
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(bad)

    got = kind.outputs(state)
    kind.release(state)
    del state
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want = kind.reference(run, got)
    verdict = judge(kind.compare(run, got, want), cell.limits)
    run.log(f"reference and comparison {time.perf_counter() - t_ref:.1f} s")

    metrics = {}
    if trace:
        for m in cell.per_layer:
            reader = load_module(
                os.path.join(cell.bench_root, "perfbench", "metrics",
                             m["name"] + ".py"),
                "perfbench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(run.device)
                    if run.device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": peak}
    windows = [run.counters] + ([run.trace["counters"]] if trace else [])
    result = {"correct": verdict["correct"],
              "attempted": int(sum(c.get("attempted", 0) for c in windows)),
              "failed": int(sum(c.get("failed", 0) for c in windows)),
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    if result["failed"]:
        result["correct"] = False
    result["checks"] = verdict["checks"]
    return result


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__(", ".join(names))
        self.names = names


def _setup_environment() -> None:
    """Every build and kernel cache of the program inside the checkout,
    at fixed paths; no JAX loaded by a library on its own."""
    cache = os.path.join(ROOT, ".perfbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"


def main(argv=None, t_start: Optional[float] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _setup_environment()
    try:
        cell = load_cell(args.workload)
    except (SpecError, OSError, KeyError) as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return EXIT_SPEC

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": no result", file=sys.stderr)
        return EXIT_NO_CARD
    print(f"perfbench: card {_power_limit()}, torch {torch.__version__}",
          file=sys.stderr, flush=True)
    # the configurations state f32: no TF32 anywhere in the process
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        # the program's prints go to standard error: the result's line is
        # the last of standard output
        with contextlib.redirect_stdout(sys.stderr):
            result = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", t_start)
    except ForbiddenModules as e:
        print(f"perfbench: loaded after the window: {e}; no result",
              file=sys.stderr)
        return EXIT_FORBIDDEN
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
