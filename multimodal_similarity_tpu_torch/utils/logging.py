"""Metrics logging: a JSONL stream of step records, the deferred per-step
readback, and the embedding-projector files (metadata and embedding TSVs,
projector config)."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict

from multimodal_similarity_tpu_torch.utils.profiling import span


class MetricsLogger:
    """Appends one JSON record per ``log`` call to
    ``<result_dir>/metrics.jsonl``."""

    def __init__(self, result_dir: str):
        self.result_dir = result_dir
        os.makedirs(result_dir, exist_ok=True)
        self._jsonl = open(os.path.join(result_dir, "metrics.jsonl"), "a")

    def log(self, step: int, scalars: Dict[str, float],
            prefix: str = "", at: float = None) -> None:
        rec = {"step": int(step), "time": at if at is not None else time.time()}
        for k, v in scalars.items():
            key = f"{prefix}{k}"
            if key in ("step", "time"):
                # never let a scalar clobber the record's own fields
                key = f"scalar_{key}"
            rec[key] = float(v)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()


class DeferredStepLogs:
    """Queue per-step device scalars; read them back every N steps.

    ``float()`` on a CUDA scalar waits for the device to finish the step, so
    reading every step's loss at once would keep the host from queueing the
    next step while the card works.  Queuing the scalars and converting them
    every ``flush_every`` appends keeps the device busy while every step's
    values are still recorded exactly (each record's ``time`` is the step's
    enqueue time).  ``flush()`` is the synchronisation point.
    """

    def __init__(self, logger: MetricsLogger, flush_every: int = 32,
                 echo: bool = True):
        self.logger = logger
        self.flush_every = max(int(flush_every), 1)
        self.echo = echo
        self._pending = []

    def append(self, step: int, device_scalars, host_scalars=None,
               echo_fn=None) -> bool:
        """Queue one step's scalars; True when this append flushed."""
        self._pending.append(
            (step, device_scalars, host_scalars, echo_fn, time.time()))
        if len(self._pending) >= self.flush_every:
            self.flush()
            return True
        return False

    def flush(self) -> None:
        """Read back and log every queued step; each step's
        ``echo_fn(scalars)`` is called and its line printed unless the
        echo is off."""
        with span("trainer.flush"):
            pending, self._pending = self._pending, []
            for step, dev, host, echo_fn, at in pending:
                scalars = {k: float(v) for k, v in dev.items()}
                if host:
                    scalars.update({k: float(v) for k, v in host.items()})
                self.logger.log(step, scalars, at=at)
                if echo_fn is not None:
                    line = echo_fn(scalars)
                    if self.echo:
                        print(line)

    def close(self) -> None:
        """Best-effort flush for crash epilogues: when a step raised, the
        queued scalars may carry the same error, and converting them must
        not mask the original traceback."""
        n = len(self._pending)
        try:
            self.flush()
        except RuntimeError as e:
            print(f"[logging] dropped up to {n} queued step records "
                  f"after error: {e!r}", file=sys.stderr)
            self._pending = []


def write_projector_embedding(result_dir: str, embeddings,
                              filename: str = "embedding_val.tsv") -> str:
    """Embedding values TSV for the TensorBoard projector."""
    path = os.path.join(result_dir, filename)
    with open(path, "w") as fout:
        for row in embeddings:
            fout.write("\t".join(f"{v:.6g}" for v in row) + "\n")
    return path


def write_projector_config(result_dir: str,
                           tensor_filename: str = "embedding_val.tsv",
                           metadata_filename: str = "metadata_val.tsv",
                           ) -> str:
    """projector_config.pbtxt wiring the embedding TSV to its metadata
    (the projector's tensor_path form; no TF checkpoint variable)."""
    path = os.path.join(result_dir, "projector_config.pbtxt")
    with open(path, "w") as fout:
        fout.write("embeddings {\n"
                   f"  tensor_path: \"{tensor_filename}\"\n"
                   f"  metadata_path: \"{metadata_filename}\"\n"
                   "}\n")
    return path


def write_projector_metadata(result_dir: str, labels, sessions=None,
                             boundaries=None,
                             filename: str = "metadata_val.tsv") -> str:
    """id/label/session/start/end TSV for the embedding projector."""
    path = os.path.join(result_dir, filename)
    with open(path, "w") as fout:
        fout.write("id\tlabel\tsession_id\tstart\tend\n")
        for i in range(len(labels)):
            lab = labels[i][0] if hasattr(labels[i], "__len__") else labels[i]
            sess = sessions[i] if sessions is not None else ""
            s, e = boundaries[i] if boundaries is not None else ("", "")
            fout.write(f"{i}\t{lab}\t{sess}\t{s}\t{e}\n")
    return path
