"""Shared utilities: logging, spans and counters, profiling, run control
(the hang watchdog and the preemption guard)."""

from multimodal_similarity_tpu_torch.utils.logging import MetricsLogger
from multimodal_similarity_tpu_torch.utils.preemption import PreemptionGuard
from multimodal_similarity_tpu_torch.utils.profiling import (
    StepWindowProfiler,
    count,
    counters,
    session,
    span,
)
from multimodal_similarity_tpu_torch.utils.watchdog import StepWatchdog

__all__ = ["MetricsLogger", "PreemptionGuard", "StepWatchdog",
           "StepWindowProfiler", "count", "counters", "session", "span"]
