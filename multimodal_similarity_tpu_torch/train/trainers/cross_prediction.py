"""Cross-modal regression (``scripts/train_cross_prediction.sh``): the core
video encoder (``encoder``) and an ``OutputLayer`` head (``head``) on
relu(embedding) regress the second modality's raw features, mean-pooled
over each event window, with a masked per-row MSE.  Its checkpoints give
the cross-predicted half of late-fusion evaluation
(``eval/evaluate_late_fusion.py --use_output``).  No validation pass: each
epoch logs ``train_mse`` (the last step's) and saves a checkpoint.

Streamed: the loader's batches (TSN segments of the video, the mean-pooled
target) go up on the feed thread (data/device_feed.py).  With
``--device_cache`` a fused step gathers them from the int8 feature cache
(_loop.py ``cache_feed``): TSN segments of the video, the target modality
mean-pooled on the device.  Single device.  No CUDA kernel of ``csrc/`` is
on this path.

Run:  python -m multimodal_similarity_tpu_torch.train.trainers.cross_prediction --DATA_ROOT <dir> --feat resnet,sensors ...
(``--device cpu`` runs on the CPU; the default is ``cuda``.)
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from multimodal_similarity_tpu_torch import resolve_device
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.data import mean_pool_input
from multimodal_similarity_tpu_torch.data.device_feed import dequant_features
from multimodal_similarity_tpu_torch.models import OutputLayer, build_encoder
from multimodal_similarity_tpu_torch.train.checkpoints import load_checkpoint
from multimodal_similarity_tpu_torch.train.state import (
    apply_gradients, build_optimizer, l2_regularization)
from multimodal_similarity_tpu_torch.train.trainers._honda import (
    HondaExperiment)
from multimodal_similarity_tpu_torch.train.trainers._loop import (
    cache_feed, run_budget_trainer)
from multimodal_similarity_tpu_torch.train.trainers.base_model_batchhard \
    import TrainResult, _check_supported


def build_model(cfg: TrainConfig, device: torch.device,
                target_dim: int) -> nn.ModuleDict:
    """The core encoder (``encoder``) and the regression head (``head``),
    weights from ``cfg.seed``, dropout masks from ``cfg.seed + 1``."""
    init_gen = torch.Generator().manual_seed(cfg.seed)
    drop_gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    return nn.ModuleDict({
        "encoder": build_encoder(
            cfg.network, num_seg=cfg.num_seg, emb_dim=cfg.emb_dim,
            n_input=cfg.n_input, n_h=cfg.n_h, n_w=cfg.n_w, n_C=cfg.n_C,
            keep_prob=cfg.keep_prob, generator=init_gen,
            dropout_generator=drop_gen),
        "head": OutputLayer(cfg.emb_dim, target_dim, keep_prob=cfg.keep_prob,
                            generator=init_gen, dropout_generator=drop_gen),
    }).to(device)


def make_regression_step(model: nn.ModuleDict, optimizer,
                         cfg: TrainConfig) -> Callable:
    """step(events, targets [B, D], mask [B], learning_rate) -> device
    scalars: the train-mode head output on relu(embedding), the per-row
    mean squared error averaged over the rows whose ``mask`` is 1.
    ``events`` dense or the int8 cache's {"q", "scale"}."""

    def step(events, targets, mask, learning_rate: float):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        pred = model["head"](torch.relu(model["encoder"](
            dequant_features(events))))
        sq = ((targets - pred) ** 2).mean(dim=1)
        mse = (sq * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        total = mse
        if cfg.lambda_l2:
            total = total + cfg.lambda_l2 * l2_regularization(model)
        total.backward()
        apply_gradients(optimizer, learning_rate)
        return {"loss": total.detach(), "mse": mse.detach()}

    return step


def train(cfg: TrainConfig, event_budget: Optional[int] = None,
          result_dir: Optional[str] = None, device=None) -> TrainResult:
    """Train on ``device`` (default ``cuda``; raises when no card is
    visible and the CPU was not asked for).  ``--model_path`` restores a
    port checkpoint (weights, optimizer state and step); the JAX trainer
    has no such restore."""
    _check_supported(cfg, "cross_prediction")
    device = resolve_device(device)
    modalities = cfg.feat if isinstance(cfg.feat, list) else \
        ["resnet", "sensors"]
    exp = HondaExperiment(cfg, modalities=modalities,
                          event_budget=event_budget, result_dir=result_dir)
    # the second modality's target: each window mean-pooled, [B, 1, D]
    exp.loader.prepare_funcs[1] = mean_pool_input
    target_dim = int(np.prod(cfg.feat_dim.get(modalities[1], (8,))))
    model = build_model(cfg, device, target_dim)
    optimizer = build_optimizer(cfg.optimizer, model, cfg.learning_rate)
    step_host = 0
    if cfg.model_path:
        step_host = load_checkpoint(cfg.model_path, model, optimizer)
    step = make_regression_step(model, optimizer, cfg)

    last = {}

    def run(batch, epoch, lr):
        targets = batch["events2"].reshape(batch["events2"].shape[0], -1)
        aux = step(batch["events"], targets, batch["mask"], lr)
        last.update(aux)
        return aux

    # --device_cache: the video's TSN segments and the target's window
    # mean, both gathered on the device; further modalities ride as TSN
    cached = cache_feed(
        exp, cfg, lambda ev, lab, m, lr: step(
            ev[0], ev[1].reshape(ev[1].shape[0], -1), m, lr), device,
        modality_modes=("tsn", "meanpool") + ("tsn",) * (len(modalities)
                                                         - 2))

    # no validation pass: the epoch's metric is its last step's MSE (read
    # back from the cached path's last step on --device_cache)
    return run_budget_trainer(
        cfg, exp, model, optimizer, run, device, step_host,
        lambda: {"train_mse": float(
            (last if cached is None else exp.last_cached_aux)["mse"])},
        device_keys=("events", "events2", "mask"), echo_keys=("mse",),
        cached=cached)


def main(argv=None):
    """The trainer CLI: the JAX trainer's flags, plus ``--device`` (default
    ``cuda``)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default=None)
    args, rest = p.parse_known_args(argv)
    train(TrainConfig.parse(rest), device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
