"""Profiling: ``torch.profiler`` traces and step timing.

The reference's observability was wall-clock prints per batch
(base_model.py:290-291); a trace shows the real device timeline.  Traces
are Chrome trace files (``*.pt.trace.json``): open them in Perfetto
(ui.perfetto.dev) or ``chrome://tracing``; device kernels are the events
of category ``kernel``.  On a CUDA build with a visible card the profiler
records CPU and CUDA activity, elsewhere the CPU alone.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _start_profile() -> torch.profiler.profile:
    """A started profiler; device work queued before it finishes first, so
    the trace holds only what is launched inside the window."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    return prof


def _stop_profile(prof: torch.profiler.profile, path: str) -> str:
    """Stop ``prof`` once the queued device work has finished, and write
    its Chrome trace to ``path``."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Trace the block into ``<log_dir>/trace_<ms>.pt.trace.json``; yields
    the path the trace will be written to (None when not ``enabled``).
    No trainer of the port calls it (``--profile_dir`` takes
    ``StepWindowProfiler``); the tests do."""
    if not enabled:
        yield None
        return
    path = os.path.join(log_dir, f"trace_{int(time.time() * 1e3)}"
                        ".pt.trace.json")
    prof = _start_profile()
    try:
        yield path
    finally:
        _stop_profile(prof, path)


def _leaves(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _leaves(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _leaves(v)


def _hard_sync(out):
    """Wait until the device work producing ``out`` (a tensor or a nested
    dict / list / tuple of them) has finished: one synchronisation of each
    CUDA device it touches; a no-op for CPU tensors."""
    devices = {t.device for t in _leaves(out) if t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


def time_fn(fn, *args, reps: int = 10, warmup: int = 1, **kwargs) -> float:
    """Mean seconds per call, synchronised on the result (``_hard_sync``).
    No trainer of the port calls it; the tests do."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    _hard_sync(out)
    t0 = time.time()
    for _ in range(reps):
        out = fn(*args, **kwargs)
    _hard_sync(out)
    return (time.time() - t0) / reps


class StepWindowProfiler:
    """Trace a window of steady-state train steps (``--profile_dir``).

    ``update(step)`` starts a ``torch.profiler`` trace when ``step``
    reaches ``start_step`` (default 1: AFTER the first step, so the trace
    shows the steady per-step timeline, not the one-time warm-up) and stops
    it ``num_steps`` steps later, writing ``trace_path``.  The window is
    relative to the first observed step, so a run resumed from a
    checkpoint still traces ``num_steps`` steps.  Call ``close()`` on
    trainer exit so an interrupted window still writes its trace.  No-op
    when ``log_dir`` is empty.
    """

    def __init__(self, log_dir: str, num_steps: int = 5,
                 start_step: int = 1):
        self.log_dir = log_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self.trace_path: Optional[str] = None
        self._base = None  # first observed step: windows are RELATIVE so
        self._prof = None  # checkpoint-resumed runs still trace num_steps
        self._first = self._last = None
        self._done = not log_dir

    @property
    def _active(self) -> bool:
        return self._prof is not None

    def update(self, step: int) -> None:
        if self._done:
            return
        if self._base is None:
            # the first observed step is the warm-up step regardless of the
            # restored step count
            self._base = step - 1
        rel = step - self._base
        self._last = step
        if not self._active and rel >= self.start_step:
            self._first = step + 1
            self._prof = _start_profile()
        elif self._active and rel >= self.stop_step:
            self._finish()

    def _finish(self) -> None:
        path = os.path.join(self.log_dir, f"trace_steps{self._first}-"
                            f"{self._last}.pt.trace.json")
        prof, self._prof = self._prof, None
        self.trace_path = _stop_profile(prof, path)
        self._done = True

    def close(self) -> None:
        """End the window; an open one is written with the steps it
        holds."""
        if self._active:
            self._finish()
        self._done = True


def device_memory_stats(device=None) -> Optional[dict]:
    """``torch.cuda.memory_stats`` of ``device`` (default: the current
    CUDA device) on the card; None on the CPU.  No trainer of the port
    calls it; the tests do."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return torch.cuda.memory_stats(dev)
