"""Shared trainer scaffolding: experiment setup, validation, epoch
bookkeeping."""

from __future__ import annotations

import os
from datetime import datetime
from typing import Callable, Optional

import numpy as np
import torch

from multimodal_similarity_tpu_torch.configs import write_configure_to_file
from multimodal_similarity_tpu_torch.eval.metrics import retrieval_metrics
from multimodal_similarity_tpu_torch.train.steps import embed_in_chunks


def setup_experiment(cfg, timestamp: bool = True,
                     result_dir: Optional[str] = None) -> str:
    """Create the result dir (<result_root>/<name>_<ts>, or the explicit
    ``result_dir``) and write the config snapshot."""
    if result_dir is None:
        name = cfg.name
        if timestamp:
            name = name + "_" + datetime.now().strftime("%Y%m%d-%H%M%S")
        result_dir = os.path.join(cfg.result_root, name)
    os.makedirs(result_dir, exist_ok=True)
    write_configure_to_file(cfg, result_dir)
    return result_dir


def validate(embed_fn, val_feats, val_labels, device: torch.device,
             loss_fn: Optional[Callable] = None, chunk: int = 256,
             beat: Optional[Callable[[], None]] = None):
    """Per-epoch validation: chunked eval-mode embedding on ``device``,
    leave-one-out retrieval metrics, and, given ``loss_fn``, the trainer's
    own objective ``loss_fn(emb, labels)`` over the whole validation set as
    ``val_loss`` (no gradient, so the batch-hard stats run without winner
    tracking and the lifted stats run their forward alone).  ``beat`` (a
    watchdog heartbeat) is called after each embedded chunk and once after
    the metrics.  Returns (metrics, embeddings tensor)."""
    emb = embed_in_chunks(embed_fn, val_feats, device, chunk=chunk,
                          beat=beat)
    labels = np.asarray(val_labels).reshape(-1)
    mAP, mPrec, recalls = retrieval_metrics(emb, labels)
    metrics = {"val_mAP": mAP, "val_mPrec": mPrec,
               "val_recall@1": recalls[1]}
    if loss_fn is not None:
        with torch.no_grad():
            metrics["val_loss"] = float(loss_fn(
                emb, torch.from_numpy(labels.astype(np.int64)).to(device))[0])
    if beat is not None:
        beat()
    return metrics, emb


def epoch_of_step(step: int, batch_per_epoch: int) -> int:
    """Resume-accurate epoch derivation."""
    return int(step) // max(batch_per_epoch, 1)
