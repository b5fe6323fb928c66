"""Unsupervised autoencoder pretraining (``scripts/unimodal_pretrain.sh``,
``MODE=sae``), the first link of the pretrain chain.

Every train session (``--label_num`` does not cut them) goes through the
session loader; ``Seq2seqTSN`` (``mode="seq2seq"``, the CLI's) reconstructs
the TSN segments of each event through its LSTM encoder-decoder, or
``SAE`` (``mode="sae"``) the flattened segments, under a masked mean
squared error.  Each epoch validates on the validation set's
reconstruction error (``val_mse``) and saves a checkpoint, whose
``Seq2seqTSN`` the clustering step embeds with.

Streamed: the loader's batches go up on the feed thread
(data/device_feed.py) through ``run_budget_trainer``; with
``--device_cache`` a fused step gathers them from the int8 feature cache
(_loop.py ``cache_feed``).  Single device.  No CUDA kernel of ``csrc/`` is
on this path.

Run:  python -m multimodal_similarity_tpu_torch.train.trainers.unimodal_pretrain_sae --DATA_ROOT <dir> --feat sensors --n_input 8 --emb_dim 128 ...
(``--device cpu`` runs on the CPU; the default is ``cuda``.)
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch

from multimodal_similarity_tpu_torch import resolve_device
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.data.device_feed import dequant_features
from multimodal_similarity_tpu_torch.models import SAE, Seq2seqTSN
from multimodal_similarity_tpu_torch.train.checkpoints import load_checkpoint
from multimodal_similarity_tpu_torch.train.state import (
    apply_gradients, build_optimizer, l2_regularization)
from multimodal_similarity_tpu_torch.train.trainers._honda import (
    HondaExperiment)
from multimodal_similarity_tpu_torch.train.trainers._loop import (
    cache_feed, run_budget_trainer)
from multimodal_similarity_tpu_torch.train.trainers.base_model_batchhard \
    import TrainResult, _check_supported

MODES = ("seq2seq", "sae")


def build_model(cfg: TrainConfig, mode: str, event_shape,
                device: torch.device) -> torch.nn.Module:
    """``Seq2seqTSN`` on [B, n_seg, n_input] events, or ``SAE`` on their
    flattening; weights from ``cfg.seed``, dropout masks from
    ``cfg.seed + 1``."""
    init_gen = torch.Generator().manual_seed(cfg.seed)
    if mode == "seq2seq":
        drop_gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
        model = Seq2seqTSN(n_seg=cfg.num_seg, n_input=event_shape[-1],
                           emb_dim=cfg.emb_dim, reverse=cfg.reverse,
                           keep_prob=cfg.keep_prob, generator=init_gen,
                           dropout_generator=drop_gen)
    else:
        model = SAE(n_input=int(np.prod(event_shape)), emb_dim=cfg.emb_dim,
                    generator=init_gen)
    return model.to(device)


def _inputs(events: torch.Tensor, mode: str) -> torch.Tensor:
    return events if mode == "seq2seq" else events.reshape(
        events.shape[0], -1)


def make_reconstruction_step(model, optimizer, cfg: TrainConfig,
                             mode: str):
    """step(events, mask, learning_rate) -> device scalars: the train-mode
    reconstruction, each row's mean squared error averaged over the rows
    whose ``mask`` is 1 (+ L2), and one optimizer step.  ``events`` dense
    or the int8 cache's {"q", "scale"}."""

    def step(events, mask, learning_rate: float):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        x = _inputs(dequant_features(events), mode)
        _, recon = model(x)
        sq = ((x - recon) ** 2).reshape(x.shape[0], -1).mean(dim=1)
        mse = (sq * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        total = mse
        if cfg.lambda_l2:
            total = total + cfg.lambda_l2 * l2_regularization(model)
        total.backward()
        apply_gradients(optimizer, learning_rate)
        return {"loss": total.detach(), "mse": mse.detach()}

    return step


def reconstruction_mse(model, feats: np.ndarray, mode: str,
                       device: torch.device, chunk: int = 1024) -> float:
    """The eval-mode mean squared reconstruction error over every element
    of ``feats``, ``chunk`` rows at a time."""
    model.eval()
    total, count = 0.0, 0
    with torch.no_grad():
        for lo in range(0, feats.shape[0], chunk):
            x = _inputs(torch.from_numpy(
                np.ascontiguousarray(feats[lo:lo + chunk])).to(device), mode)
            _, recon = model(x)
            total += float(((x - recon) ** 2).sum())
            count += x.numel()
    return total / max(count, 1)


def train(cfg: TrainConfig, mode: str = "seq2seq",
          event_budget: Optional[int] = None,
          result_dir: Optional[str] = None, device=None) -> TrainResult:
    """Train on ``device`` (default ``cuda``; raises when no card is
    visible and the CPU was not asked for).  ``--model_path`` restores a
    port checkpoint (weights, optimizer state and step); the JAX trainer
    has no such restore."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}; expected one of {MODES}")
    _check_supported(cfg, "unimodal_pretrain_sae")
    device = resolve_device(device)
    exp = HondaExperiment(cfg, event_budget=event_budget,
                          result_dir=result_dir, limit_label_num=False)
    model = build_model(cfg, mode, exp.val_feats.shape[1:], device)
    optimizer = build_optimizer(cfg.optimizer, model, cfg.learning_rate)
    step_host = 0
    if cfg.model_path:
        step_host = load_checkpoint(cfg.model_path, model, optimizer)
    step = make_reconstruction_step(model, optimizer, cfg, mode)

    return run_budget_trainer(
        cfg, exp, model, optimizer,
        lambda batch, epoch, lr: step(batch["events"], batch["mask"], lr),
        device, step_host,
        lambda: {"val_mse": reconstruction_mse(model, exp.val_feats, mode,
                                               device)},
        device_keys=("events", "mask"), echo_keys=("mse",),
        cached=cache_feed(exp, cfg, lambda ev, lab, m, lr: step(ev[0], m, lr),
                          device))


def main(argv=None):
    """The trainer CLI: the JAX trainer's flags, plus ``--device`` (default
    ``cuda``)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default=None)
    args, rest = p.parse_known_args(argv)
    train(TrainConfig.parse(rest), device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
