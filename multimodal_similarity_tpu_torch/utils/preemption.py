"""Preemption-safe shutdown: catch SIGTERM, finish the step, checkpoint.

Batch schedulers deliver SIGTERM with a grace window before a kill.  The
trainers poll ``should_stop`` at step boundaries and write a final
checkpoint of the exact step before exiting, so a run resumed with
``--model_path`` loses no optimizer step.

Usage (the pattern the trainers follow)::

    with PreemptionGuard() as guard:
        for batch in stream:
            step(batch)
            if guard.should_stop:
                ckpt.save(model, optimizer, step_count)
                break

The handler only sets a flag (no I/O happens in signal context) and chains
any previously installed handler, so embedding frameworks keep their own
shutdown hooks.  Installing from a non-main thread (where CPython forbids
``signal.signal``) degrades to an inert guard rather than failing, so
library users can call trainers from worker threads.

The signal must reach the *python* process: wrapping the trainer in a shell
pipeline and signalling the shell orphans the trainer instead of stopping
it (use ``exec`` or signal the python pid).  A step that never returns runs
no Python handler at all; that is a hang, which the watchdog covers
(``--watchdog_secs``, utils/watchdog.install_hang_watchdog: a fired
watchdog requests a stop on this guard, so the two compose).
``should_stop`` re-asserts the OS disposition at every poll, so anything
that replaces the handler from native code is overridden within one step.

On a multi-process run the stop is decided collectively
(:func:`sync_should_stop`, an all-reduce over the process group) and only
process 0 writes the checkpoint (:func:`report_preemption`).
"""

from __future__ import annotations

import signal
import threading
from typing import Callable, Optional, Sequence


class PreemptionGuard:
    """Flag-setting SIGTERM/SIGINT guard with handler chaining."""

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._stop = threading.Event()
        self._previous: dict = {}
        self._installed = False
        self._signal_time: Optional[float] = None  # first REAL signal

    # -- lifecycle ---------------------------------------------------------
    def install(self) -> "PreemptionGuard":
        if self._installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            return self  # inert: CPython only allows handlers on main
        for sig in self._signals:
            self._previous[sig] = signal.signal(sig, self._handle)
        self._installed = True
        return self

    def restore(self) -> None:
        if not self._installed:
            return
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()
        self._installed = False

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.restore()

    # -- signal path -------------------------------------------------------
    #: seconds a first SIGTERM gets to reach a checkpoint before a repeat
    #: escalates to termination: supervisors commonly deliver duplicates
    #: within milliseconds (process group + child), which must NOT kill the
    #: run before any step-boundary poll could respond.  Sized to a real
    #: preemption grace window (tens of seconds): a long validation pass or
    #: a slow step must be allowed to reach its next step-boundary poll even
    #: if the supervisor re-delivers SIGTERM periodically in the meantime.
    #: Class attribute: override per guard instance when a platform's grace
    #: window is known.
    ESCALATE_AFTER_S = 45.0

    def _handle(self, signum, frame) -> None:
        import time

        if self._signal_time is not None and \
                time.monotonic() - self._signal_time > self.ESCALATE_AFTER_S:
            # repeated signal after a real grace window: the sender means
            # it; restore the previous dispositions and re-deliver so
            # termination proceeds even if no loop is polling this guard
            # (e.g. it leaked past an exception, or the work is stuck)
            self.restore()
            signal.raise_signal(signum)
            return
        if self._signal_time is None:
            self._signal_time = time.monotonic()
        self._stop.set()
        prev = self._previous.get(signum)
        if callable(prev):  # chain embedding frameworks' own hooks
            prev(signum, frame)

    # -- consumer API ------------------------------------------------------
    @property
    def should_stop(self) -> bool:
        # Re-assert the OS disposition on every poll: native code may reset
        # the process's SIGTERM disposition, which would let a later signal
        # kill the process despite an installed Python handler.  One
        # sigaction syscall per step boundary is free; it shrinks the
        # clobber window to at most one step.
        if self._installed and \
                threading.current_thread() is threading.main_thread():
            for sig in self._signals:
                try:
                    # don't clobber ANOTHER live guard's handler (nested
                    # guards: a library caller wrapping a trainer that
                    # installs its own).  When getsignal returns OUR OWN
                    # handler we still re-assert: getsignal only reflects
                    # the Python-level view, so after a native sigaction
                    # clobber it keeps returning this handler even though
                    # the OS disposition is gone.
                    cur = signal.getsignal(sig)
                    owner = getattr(cur, "__self__", None)
                    if isinstance(owner, PreemptionGuard) and \
                            owner is not self:
                        continue
                    signal.signal(sig, self._handle)
                except (ValueError, OSError):  # pragma: no cover
                    pass
        return self._stop.is_set()

    def request_stop(self) -> None:
        """Programmatic stop (tests, orchestration glue, the watchdog)."""
        self._stop.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._stop.wait(timeout)


def any_process(flag: bool) -> bool:
    """True when ``flag`` is set on any process of the default
    ``torch.distributed`` group: an ``all_reduce(MAX)`` of one int32, on
    the rank's CUDA device under NCCL and on the CPU otherwise."""
    import torch
    import torch.distributed as dist

    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def sync_should_stop(guard: PreemptionGuard, pcount: int = 1,
                     step: Optional[int] = None, every: int = 8) -> bool:
    """Collective stop decision for multi-process training.

    A SIGTERM may reach only some processes (or at different step
    boundaries); a process that exits alone leaves its peers blocked in
    the next collective.  When more than one process is live, reduce each
    process's local flag with :func:`any_process` and stop iff ANY saw the
    signal: every process then leaves the step loop at the same step
    boundary, keeping the final checkpoint and the collectives in lockstep.

    The reduction blocks the host thread, so per-step polling would gate
    every step on the slowest process: pass the (lockstep) ``step``
    counter and the collective runs only every ``every`` steps.  Every
    process computes the same throttle decision, keeping the collective
    call counts aligned.  Omit ``step`` to force a sync (e.g. once per
    epoch boundary)."""
    if pcount <= 1:
        return guard.should_stop
    if step is not None and every > 1 and step % every:
        return False
    return any_process(guard.should_stop)


def report_preemption(name: str, step: int, save: Callable[[int], None],
                      pid: int = 0) -> None:
    """Shared preemption epilogue: process 0 checkpoints the exact step
    (``save(step)``); other processes report that they are stopping
    without claiming a checkpoint they did not write."""
    step = int(step)
    if pid == 0:
        save(step)
        print(f"[{name}] preemption signal: checkpointed at step {step}; "
              f"exiting", flush=True)
    else:
        print(f"[{name}] preemption signal: stopping at step {step} "
              f"(checkpoint owned by process 0); exiting", flush=True)
