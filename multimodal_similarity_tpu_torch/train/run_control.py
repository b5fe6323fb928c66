"""Run control of one training run: the ``--profile_dir`` step-window
trace, the SIGTERM guard and the ``--watchdog_secs`` hang watchdog, with
the step-boundary stop poll and the checkpoint-and-stop epilogue.  The
Honda experiment scaffolding (trainers/_honda.py) and ``base_model_tf``
each hold one."""

from __future__ import annotations

from typing import Callable, Optional

from multimodal_similarity_tpu_torch.utils import preemption
from multimodal_similarity_tpu_torch.utils.profiling import (
    StepWindowProfiler)
from multimodal_similarity_tpu_torch.utils.watchdog import (
    install_hang_watchdog)


class RunControl:
    """Armed on construction, torn down by ``close``.

    The profiler traces ``cfg.profile_steps`` steps into
    ``cfg.profile_dir`` (process 0 only).  The SIGTERM guard is installed
    now and restored by ``close``; it is looked up on its module, so that
    a test may replace the class.  The watchdog (None when
    ``cfg.watchdog_secs`` is 0) dumps every thread's traceback on expiry
    and requests a stop on the guard, so the next step-boundary poll
    checkpoints the exact step.  ``pid`` / ``pcount``: this process of a
    multi-process run, whose stop decision is collective."""

    def __init__(self, cfg, pid: int = 0, pcount: int = 1):
        self.name, self.pid, self.pcount = cfg.name, pid, pcount
        self.profiler = StepWindowProfiler(
            cfg.profile_dir if pid == 0 else "", num_steps=cfg.profile_steps)
        self.guard = preemption.PreemptionGuard().install()
        self.watchdog = install_hang_watchdog(cfg.name, cfg.watchdog_secs,
                                              self.guard)

    @property
    def beat_fn(self) -> Optional[Callable[[], None]]:
        """The watchdog's heartbeat for long passes between steps
        (validation chunks, cache builds), or None without a watchdog."""
        return self.watchdog.beat if self.watchdog is not None else None

    def step_done(self, step: int) -> None:
        """After a step's scalars are queued or read back: advance the
        trace window and beat the watchdog."""
        self.profiler.update(step)
        if self.watchdog is not None:
            self.watchdog.beat()

    def stop_requested(self, step: Optional[int] = None) -> bool:
        """The step-boundary poll: this process's guard, or on more than
        one process the collective decision (every 8th ``step``; ``None``
        forces it)."""
        return preemption.sync_should_stop(self.guard, self.pcount,
                                           step=step)

    def preempted(self, step: int, save: Callable[[int], None],
                  collective_save: bool = False) -> bool:
        """On a preemption signal or a fired watchdog: ``save(step)`` on
        process 0 (so ``--model_path`` resumes with no lost step), report,
        and return True for the caller to leave its loop.
        ``collective_save``: ``save`` is a collective that every process
        calls (a tensor-parallel run gathers its shards; process 0
        writes)."""
        if not self.stop_requested():
            return False
        if collective_save and self.pid != 0:
            save(step)
        preemption.report_preemption(self.name, step, save, self.pid)
        return True

    def close(self) -> None:
        if self.watchdog is not None:
            self.watchdog.cancel()
        self.guard.restore()
        self.profiler.close()
