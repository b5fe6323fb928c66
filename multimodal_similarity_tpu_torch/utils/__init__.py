"""Shared utilities: logging, timing, profiling, run control (the hang
watchdog and the preemption guard)."""

from multimodal_similarity_tpu_torch.utils.logging import MetricsLogger
from multimodal_similarity_tpu_torch.utils.preemption import PreemptionGuard
from multimodal_similarity_tpu_torch.utils.profiling import (
    StepWindowProfiler,
    device_memory_stats,
    time_fn,
    trace,
)
from multimodal_similarity_tpu_torch.utils.timing import StepTimer
from multimodal_similarity_tpu_torch.utils.watchdog import StepWatchdog

__all__ = ["MetricsLogger", "PreemptionGuard", "StepTimer", "StepWatchdog",
           "StepWindowProfiler", "trace", "time_fn", "device_memory_stats"]
