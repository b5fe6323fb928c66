"""Softmax-classification baseline (``scripts/train_base_classifier.sh``):
``ConvTSNClassifier`` (ConvTSN with a per-segment head averaged over
segments, ``n_output`` 7, the goal classes after the label transfer),
masked cross-entropy over each batch's real events, the masked accuracy,
and per epoch the validation accuracy from the eval-mode logits and a
checkpoint.

Streamed: the loader's batches go up on the feed thread
(data/device_feed.py).  Labels must lie in [0, n_output): an index outside
it makes ``gather`` raise (a device-side assert on the card).  Single
device; no CUDA kernel of ``csrc/`` is on this path.

Run:  python -m multimodal_similarity_tpu_torch.train.trainers.base_model_classifier --DATA_ROOT <dir> --network convtsn --emb_dim 256 ...
(``--device cpu`` runs on the CPU; the default is ``cuda``.)
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_similarity_tpu_torch import resolve_device
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.models import ConvTSNClassifier
from multimodal_similarity_tpu_torch.train.checkpoints import load_checkpoint
from multimodal_similarity_tpu_torch.train.state import (
    apply_gradients, build_optimizer, l2_regularization)
from multimodal_similarity_tpu_torch.train.trainers._honda import (
    HondaExperiment)
from multimodal_similarity_tpu_torch.train.trainers._loop import (
    run_budget_trainer)
from multimodal_similarity_tpu_torch.train.trainers.base_model_batchhard \
    import TrainResult, _check_supported

N_OUTPUT = 7


def build_model(cfg: TrainConfig, device: torch.device,
                n_output: int = N_OUTPUT) -> ConvTSNClassifier:
    """The classifier of ``cfg``: weights from ``cfg.seed``, dropout masks
    from ``cfg.seed + 1``."""
    return ConvTSNClassifier(
        n_seg=cfg.num_seg, emb_dim=cfg.emb_dim, n_input=cfg.n_input,
        n_h=cfg.n_h, n_w=cfg.n_w, n_C=cfg.n_C, n_output=n_output,
        keep_prob=cfg.keep_prob,
        generator=torch.Generator().manual_seed(cfg.seed),
        dropout_generator=torch.Generator(device=device).manual_seed(
            cfg.seed + 1)).to(device)


def make_classifier_step(model: nn.Module, optimizer,
                         cfg: TrainConfig) -> Callable:
    """step(events, labels [B], mask [B], learning_rate) -> device
    scalars: cross-entropy and accuracy over the rows whose ``mask`` is
    1, one optimizer step on the cross-entropy."""

    def step(events, labels, mask, learning_rate: float):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        _, logits = model(events)
        labels = labels.reshape(-1).long()
        nll = -F.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
        denom = torch.clamp(mask.sum(), min=1.0)
        ce = (nll * mask).sum() / denom
        correct = (logits.argmax(dim=-1) == labels).float()
        acc = (correct * mask).sum() / denom
        total = ce
        if cfg.lambda_l2:
            total = total + cfg.lambda_l2 * l2_regularization(model)
        total.backward()
        apply_gradients(optimizer, learning_rate)
        return {"loss": total.detach(), "ce": ce.detach(),
                "accuracy": acc.detach()}

    return step


def val_accuracy(model: nn.Module, val_feats: torch.Tensor,
                 val_labels: np.ndarray, chunk: int = 256) -> float:
    """The share of validation events whose eval-mode logits' argmax is
    their label."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            pred = torch.cat([model(val_feats[i:i + chunk])[1].argmax(-1)
                              for i in range(0, val_feats.shape[0], chunk)])
    finally:
        model.train(was_training)
    return float(np.mean(pred.cpu().numpy() == val_labels.reshape(-1)))


def train(cfg: TrainConfig, event_budget: Optional[int] = None,
          result_dir: Optional[str] = None, n_output: int = N_OUTPUT,
          device=None) -> TrainResult:
    """Train on ``device`` (default ``cuda``; raises when no card is
    visible and the CPU was not asked for).  ``--model_path`` restores a
    port checkpoint (weights, optimizer state and step); the JAX trainer
    has no such restore."""
    _check_supported(cfg, "base_model_classifier", no_cache=True)
    device = resolve_device(device)
    exp = HondaExperiment(cfg, event_budget=event_budget,
                          result_dir=result_dir)
    model = build_model(cfg, device, n_output)
    optimizer = build_optimizer(cfg.optimizer, model, cfg.learning_rate)
    step_host = 0
    if cfg.model_path:
        step_host = load_checkpoint(cfg.model_path, model, optimizer)
    step = make_classifier_step(model, optimizer, cfg)
    val_x = torch.from_numpy(exp.val_feats).to(device)
    return run_budget_trainer(
        cfg, exp, model, optimizer,
        lambda b, epoch, lr: step(b["events"], b["labels"], b["mask"], lr),
        device, step_host,
        lambda: {"val_accuracy": val_accuracy(model, val_x, exp.val_labels)},
        echo_keys=("accuracy",))


def main(argv=None):
    """The trainer CLI: the JAX trainer's flags, plus ``--device`` (default
    ``cuda``)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default=None)
    args, rest = p.parse_known_args(argv)
    train(TrainConfig.parse(rest), device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
