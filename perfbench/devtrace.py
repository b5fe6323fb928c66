"""The traced run: ``torch.profiler`` over a window, recording the card's
activity alone, reduced to its busy time (the union of its operations'
intervals), the operations that took most time, and the idle gaps by the
benchmark span the host was in when they fell.

The profiler records no host activity: recording every host operation
would slow a step whose host issues its operations, and the trace would
then measure the profiler.  The window is the host's, synchronised at
both ends, so every operation of the trace falls in it.  A
``torch.cuda._sleep`` kernel launched on the idle card as the window
opens ties the host's clock to the trace's, so that the benchmark's
spans, taken on the host's clock, tell which call the host was in during
each idle gap; where the trace lacks it, the window's first operation
and first span stand in."""

from __future__ import annotations

import bisect
import json
import math
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

# trace categories of work on the card
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the kernel of torch.cuda._sleep, which marks the window's start
MARKER = "spin_kernel"
MARK_CYCLES = 1000
# where the host was in no span of the benchmark's
OUTSIDE = "outside any call"


def union_length(intervals: List[Tuple[float, float]], lo: float,
                 hi: float) -> Tuple[float, List[Tuple[float, float]]]:
    """(covered length, gaps) of ``intervals`` clipped to [lo, hi]; the
    gaps are the stretches of [lo, hi] that no interval covers."""
    busy, gaps, cursor = 0.0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cursor:
            gaps.append((cursor, s))
            busy += e - s
            cursor = e
        elif e > cursor:
            busy += e - cursor
            cursor = e
    if cursor < hi:
        gaps.append((cursor, hi))
    return busy, gaps


def _short(name: str, width: int = 160) -> str:
    """A kernel's name without the leading ``void`` and cut to ``width``
    characters: template arguments run to thousands."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= width else name[:width - 3] + "..."


def reduce_events(events: List[dict], host_t0: float, host_t1: float,
                  host_spans: List[Tuple[float, float, str]],
                  top: int = 10) -> dict:
    """A chrome trace's events -> ``window_s``, ``busy_s`` (seconds), the
    ``top`` device operations by summed time, the ``top`` spans by the
    summed idle time of the card while the host was in them, and
    ``marked`` (whether the marker kernel tied the two clocks).

    The window runs from ``host_t0``, when the marker was launched, to
    ``host_t1`` (seconds, host clock); ``host_spans`` are (start, end,
    name) on the same clock."""
    device, marks = [], []
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat", "") not in DEVICE_CATS:
            continue
        start, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        name = ev.get("name", "?")
        if MARKER in name:
            marks.append(start)
        else:
            device.append((start, start + dur, name))
    if not device:
        raise RuntimeError("the trace holds no operation on the card")
    # trace time = 1e6 * host time + offset: the marker started about when
    # the host launched it; without it, the first operation about when the
    # first span opened
    if marks:
        offset = min(marks) - 1e6 * host_t0
    else:
        first = min(s for s, _, _ in host_spans) if host_spans else host_t0
        offset = min(s for s, _, _ in device) - 1e6 * first
    lo, hi = 1e6 * host_t0 + offset, 1e6 * host_t1 + offset
    # every operation falls in the window; the union is not clipped, so
    # that an error of the offset moves no busy time out of it
    busy, _ = union_length([(s, e) for s, e, _ in device], -math.inf,
                           math.inf)
    _, gaps = union_length([(s, e) for s, e, _ in device], lo, hi)
    ops: Dict[str, float] = {}
    for s, e, name in device:
        ops[name] = ops.get(name, 0.0) + (e - s)
    spans = sorted((1e6 * s + offset, 1e6 * e + offset, name)
                   for s, e, name in host_spans)
    starts = [s for s, _, _ in spans]
    idle: Dict[str, float] = {}
    for gs, ge in gaps:
        mid = 0.5 * (gs + ge)
        i = bisect.bisect_right(starts, mid) - 1
        name = spans[i][2] if i >= 0 and spans[i][1] > mid else OUTSIDE
        idle[name] = idle.get(name, 0.0) + (ge - gs)

    def ranked(d):
        return [[_short(k), v / 1e6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"window_s": host_t1 - host_t0, "busy_s": busy / 1e6,
            "device_ops": ranked(ops), "idle_gaps": ranked(idle),
            "n_device_events": len(device), "marked": bool(marks)}


class DeviceTrace:
    """``with DeviceTrace(run) as tr: <window>`` then ``tr.reduce()``:
    profiles the card's activity over the window, with the benchmark's
    spans kept on the host's clock, and returns the reduction.  The chrome
    trace goes to a temporary file under ``TMPDIR``, deleted once read.
    On the CPU (the harness's own tests) nothing is profiled and the
    reduction holds the host's window alone."""

    def __init__(self, run):
        self.run = run
        self.prof = None
        self.cuda = run.device.type == "cuda"
        self.t0 = self.t1 = None
        self.spans: List[Tuple[float, float, str]] = []

    def _mark(self):
        import torch
        torch.cuda._sleep(MARK_CYCLES)

    def __enter__(self):
        run = self.run
        run.synchronize()
        if self.cuda:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        run.spans.start()
        self.t0 = time.perf_counter()
        if self.cuda:
            self._mark()
        return self

    def __exit__(self, *exc):
        run = self.run
        run.synchronize()
        self.t1 = time.perf_counter()
        self.spans = run.spans.stop()
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def reduce(self) -> dict:
        if self.prof is None:
            return {"window_s": self.t1 - self.t0, "busy_s": 0.0,
                    "device_ops": [], "idle_gaps": [],
                    "n_device_events": 0, "marked": False}
        fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        out = reduce_events(events, self.t0, self.t1, self.spans)
        self.run.log(f"trace: window {out['window_s']:.3f} s, card busy "
                     f"{out['busy_s']:.3f} s, {out['n_device_events']} "
                     f"device events, clocks tied by "
                     f"{'the marker' if out['marked'] else 'the first call'}")
        return out


def idle_share(run) -> Optional[float]:
    """The card's idle share of the measured window, in percent: 100 (1 -
    b n / w), where b is the card's busy time a unit of work (a step, a
    call) in the traced window, n the units and w the length of the
    measured window.  The traced window's own share, which the profiler's
    cost to the host stretches, is in the result's ``device``.  None
    where the trace holds no operation on the card."""
    tr = run.trace
    if not tr or not tr.get("n_device_events"):
        return None
    units_traced = tr["counters"].get("attempted")
    units = run.counters.get("attempted")
    if not units_traced or not units or not run.window_s:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / units_traced * units
                    / run.window_s)
