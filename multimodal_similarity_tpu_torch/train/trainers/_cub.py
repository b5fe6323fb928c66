"""What the CUB trainers share: the class index the batch sampler draws
from, the run's logger and checkpoints, and the validation on the test
split."""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from multimodal_similarity_tpu_torch.eval.metrics import retrieval_metrics
from multimodal_similarity_tpu_torch.train.checkpoints import (
    CheckpointManager, load_checkpoint)
from multimodal_similarity_tpu_torch.train.steps import embed_in_chunks
from multimodal_similarity_tpu_torch.train.trainer import (
    epoch_of_step, setup_experiment)
from multimodal_similarity_tpu_torch.utils.logging import MetricsLogger


def class_index(labels: np.ndarray) -> Dict[int, list]:
    """label -> the rows that carry it, in row order (the batch sampler's
    ``class_idx_dict``)."""
    out: Dict[int, list] = {}
    for i, label in enumerate(labels):
        out.setdefault(int(label), []).append(i)
    return out


class CUBRun:
    """A trainer run's result dir, JSONL logger and checkpoints."""

    def __init__(self, cfg, result_dir: Optional[str]):
        self.cfg = cfg
        self.result_dir = setup_experiment(cfg, result_dir=result_dir)
        self.logger = MetricsLogger(self.result_dir)
        self.ckpt = CheckpointManager(self.result_dir, cfg.name)

    def first_epoch(self, model, optimizer) -> int:
        """Restores ``--model_path`` (weights, buffers and optimizer state)
        when it is set; the epoch the run starts from (one step an
        epoch)."""
        if not self.cfg.model_path:
            return 0
        return epoch_of_step(load_checkpoint(self.cfg.model_path, model,
                                             optimizer), 1)

    def validates(self, epoch: int, max_epochs: int) -> bool:
        """Every ``max_epochs // 5`` epochs, and after the last."""
        return ((epoch + 1) % max(max_epochs // 5, 1) == 0
                or epoch == max_epochs - 1)

    def validate(self, step: int, embed_fn: Callable, val_x, val_labels,
                 device: torch.device, recalls: Iterable[int] = (1,),
                 chunk: int = 256) -> Tuple[dict, torch.Tensor]:
        """Eval-mode embeddings of the test split, ``chunk`` rows at a
        time; the leave-one-out mAP and recall@k for k in ``recalls``,
        logged at ``step``.  Returns (metrics, embeddings)."""
        emb = embed_in_chunks(embed_fn, val_x, device, chunk=chunk)
        mAP, _, rec = retrieval_metrics(emb, val_labels, ks=tuple(recalls))
        metrics = {"val_mAP": mAP,
                   **{f"val_recall@{k}": rec[k] for k in recalls}}
        self.logger.log(step, metrics)
        if not self.cfg.silent_mode:
            print(f"[{self.cfg.name}] step {step} R@1 {rec[1]:.4f} "
                  f"mAP {mAP:.4f}")
        return metrics, emb

    def close(self) -> None:
        self.logger.close()
