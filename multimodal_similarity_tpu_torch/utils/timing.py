"""Wall-clock step timing, mirroring the reference's per-batch
load/select/train timers (base_model.py:244-291), synchronised on the
device values a phase produces so device work is actually measured
(utils/profiling._hard_sync)."""

from __future__ import annotations

import contextlib
import time
from typing import Dict


class _PhaseHandle:
    """Yielded by StepTimer.phase so the body can register the device
    value it produces (a value passed at context entry cannot exist yet):

        with timer.phase("train") as ph:
            aux = step(...)
            ph.sync_on(aux["loss"])
    """

    def __init__(self, value=None):
        self.value = value

    def sync_on(self, value) -> None:
        self.value = value


class StepTimer:
    """Accumulates named phase durations; register a device value via the
    yielded handle's ``sync_on`` (or pass an already-existing one as
    ``block_on``) to synchronise before the clock stops; otherwise the
    recorded duration is the asynchronous launch time, not device
    execution.  No trainer of the port uses it; the tests do."""

    def __init__(self):
        self.durations: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        handle = _PhaseHandle(block_on)
        start = time.time()
        try:
            yield handle
        finally:
            if handle.value is not None:
                from multimodal_similarity_tpu_torch.utils.profiling import (
                    _hard_sync)
                _hard_sync(handle.value)
            self.durations[name] = self.durations.get(name, 0.0) + \
                (time.time() - start)

    def reset(self) -> Dict[str, float]:
        out = dict(self.durations)
        self.durations.clear()
        return out
