"""Step watchdog: hang detection for long-running loops.

The reference had no failure detection (SURVEY.md §5); recovery was manual
restart-from-checkpoint.  This watchdog covers the detection half: a
background timer that fires a callback (default: dump Python tracebacks to
stderr) when a step exceeds its deadline — useful for catching wedged
device calls or stuck host loaders in unattended runs.  Recovery remains
checkpoint-based (train/checkpoints.py restores are step-accurate).  The
module imports nothing but the standard library: a copy of the JAX package's
``utils/watchdog.py``.
"""

from __future__ import annotations

import faulthandler
import sys
import threading
from typing import Callable, Optional


class StepWatchdog:
    """Arm per step; bark if the step doesn't complete within ``timeout``.

    Usage:
        wd = StepWatchdog(timeout=300)
        for batch in loader:
            with wd.step():
                train_step(...)
    """

    def __init__(self, timeout: float,
                 on_timeout: Optional[Callable[[], None]] = None,
                 repeat: bool = False):
        self.timeout = timeout
        self.on_timeout = on_timeout or self._default_handler
        self.repeat = repeat
        self._timer: Optional[threading.Timer] = None
        # generation guard: a repeat re-arm racing the step's __exit__
        # must not leave an orphan timer barking at a stale deadline
        self._lock = threading.Lock()
        self._generation = 0
        self.fired = 0

    def _default_handler(self) -> None:
        sys.stderr.write(
            f"[watchdog] step exceeded {self.timeout}s — thread dump:\n")
        faulthandler.dump_traceback(file=sys.stderr)

    def _fire(self, generation: int) -> None:
        self.fired += 1
        self.on_timeout()
        if self.repeat:
            with self._lock:
                if generation == self._generation:
                    self._arm_locked()

    def _arm(self) -> None:
        with self._lock:
            self._generation += 1
            self._arm_locked()

    def _arm_locked(self) -> None:
        self._timer = threading.Timer(self.timeout, self._fire,
                                      args=(self._generation,))
        self._timer.daemon = True
        self._timer.start()

    def _disarm(self) -> None:
        with self._lock:
            self._generation += 1
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None

    def step(self):
        return _StepScope(self)

    # -- heartbeat API (trainer integration, --watchdog_secs) --------------
    def beat(self) -> None:
        """Reset the deadline: the consumer made progress.  The trainers
        call this from exp.log_deferred after every step (whose queued
        scalars are read back every --log_flush_every steps), so the armed
        window covers launch + device execution + readback + the loader
        wait — everything between heartbeats."""
        self._disarm()
        self._arm()

    def cancel(self) -> None:
        """Disarm without re-arming (shutdown path)."""
        self._disarm()


class _StepScope:
    def __init__(self, wd: StepWatchdog):
        self.wd = wd

    def __enter__(self):
        self.wd._arm()
        return self.wd

    def __exit__(self, *exc):
        self.wd._disarm()
        return False


def install_hang_watchdog(name: str, secs: float,
                          guard) -> Optional[StepWatchdog]:
    """--watchdog_secs wiring shared by every loop trainer.

    Returns an ARMED heartbeat watchdog (or None when disabled): call
    ``.beat()`` after each step's scalar readback and ``.cancel()`` on
    shutdown.  On expiry it dumps every thread's traceback to stderr and
    requests a preemption-style stop on ``guard``
    (utils/preemption.PreemptionGuard), so the trainer's existing
    step-boundary poll checkpoints the exact step and exits — if the
    wedged step eventually returns, no work is lost; if it never returns,
    the thread dump is the diagnostic.  Size ``secs`` above the first
    step's warm-up time — epoch-boundary validation does NOT need to fit
    in the window, because the chunked val embed beats per chunk
    (train/trainer.validate's ``beat``), so only a single step, warm-up
    or val chunk must beat the deadline.
    """
    if not secs or secs <= 0:
        return None

    def _on_hang() -> None:
        sys.stderr.write(
            f"[{name}] watchdog: no step completed in {secs}s — "
            f"requesting checkpoint-and-stop; thread dump follows\n")
        faulthandler.dump_traceback(file=sys.stderr)
        guard.request_stop()

    wd = StepWatchdog(secs, on_timeout=_on_hang)
    wd.beat()  # arm: the clock starts now
    return wd
