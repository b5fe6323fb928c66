"""Batch-hard trainer on class-balanced batches.

Round-robin class-balanced batches from the session loader, the encoder,
l2-normalisation, and the batch-hard objective of "In Defense of the
Triplet Loss" through the fused CUDA stats kernel
(ops/kernels/batch_hard.py), Adam (eps=0.1), per-epoch leave-one-out
validation and a checkpoint.  Streamed, single device: more than one
visible GPU is not sharded.

Run:  python -m multimodal_similarity_tpu_torch.train.trainers.base_model_batchhard --DATA_ROOT <dir> ...
"""

from __future__ import annotations

import itertools
import random
import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

from multimodal_similarity_tpu_torch import resolve_device
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.models import build_encoder
from multimodal_similarity_tpu_torch.ops.kernels import batch_hard_fused
from multimodal_similarity_tpu_torch.ops.mining import select_batch_balanced
from multimodal_similarity_tpu_torch.train.checkpoints import load_checkpoint
from multimodal_similarity_tpu_torch.train.state import (
    apply_gradients, build_optimizer, l2_regularization,
    learning_rate_schedule)
from multimodal_similarity_tpu_torch.train.steps import (
    l2_normalize, make_embed_fn)
from multimodal_similarity_tpu_torch.train.trainer import (
    epoch_of_step, validate)
from multimodal_similarity_tpu_torch.train.trainers._honda import (
    HondaExperiment)


class TrainResult(NamedTuple):
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    metrics: dict
    result_dir: str


def _check_supported(cfg: TrainConfig, loss_kind: str) -> None:
    """Raise for every option whose feature is not ported yet, naming the
    ROADMAP slice that ports it."""
    if loss_kind != "batchhard":
        raise NotImplementedError(
            f"loss_kind={loss_kind!r} is not ported yet (ROADMAP slice 2)")
    unported = (
        (cfg.device_cache, "--device_cache", 8),
        (cfg.steps_per_dispatch > 1, "--steps_per_dispatch", 8),
        (cfg.int8_features, "--int8_features", 3),
        (cfg.bf16_features, "--bf16_features", 3),
        (cfg.multihost, "--multihost", 8),
        (cfg.model_parallel > 1, "--model_parallel", 8),
        (bool(cfg.profile_dir), "--profile_dir", 8),
        (cfg.watchdog_secs > 0, "--watchdog_secs", 8),
    )
    for is_set, flag, slice_no in unported:
        if is_set:
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP slice {slice_no})")


def make_balanced_batch_step(model, optimizer, cfg: TrainConfig, margin,
                             precision: str = "bf16"):
    """step(events [B, ...], labels [B], learning_rate) -> device scalars,
    one optimizer step of the batch-hard loss over a class-balanced
    batch."""

    def step(events: torch.Tensor, labels: torch.Tensor,
             learning_rate: float):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        emb = model(events)
        if cfg.normalized:
            emb = l2_normalize(emb)
        loss, num_active, *_ = batch_hard_fused(
            emb, labels, margin, weighted=True, precision=precision)
        total = loss
        if cfg.lambda_l2:
            total = total + cfg.lambda_l2 * l2_regularization(model)
        total.backward()
        apply_gradients(optimizer, learning_rate)
        return {"loss": total.detach(), "metric_loss": loss.detach(),
                "active_count": num_active.detach()}

    return step


def train(cfg: TrainConfig, loss_kind: str = "batchhard",
          event_budget: Optional[int] = None,
          result_dir: Optional[str] = None, device=None) -> TrainResult:
    """Train on ``device`` (default ``cuda``; raises when no card is
    visible and the CPU was not asked for)."""
    _check_supported(cfg, loss_kind)
    device = resolve_device(device)
    exp = HondaExperiment(cfg, event_budget=event_budget,
                          result_dir=result_dir)
    init_gen = torch.Generator().manual_seed(cfg.seed)
    drop_gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    model = build_encoder(cfg.network, num_seg=cfg.num_seg,
                          emb_dim=cfg.emb_dim, n_input=cfg.n_input,
                          n_h=cfg.n_h, n_w=cfg.n_w, n_C=cfg.n_C,
                          keep_prob=cfg.keep_prob, generator=init_gen,
                          dropout_generator=drop_gen).to(device)
    optimizer = build_optimizer(cfg.optimizer, model, cfg.learning_rate)
    step_host = 0
    if cfg.model_path:
        step_host = load_checkpoint(cfg.model_path, model, optimizer)

    embed_fn = make_embed_fn(model, cfg.normalized)
    batch_size = cfg.batch_size if cfg.batch_size > 8 else 64
    margin = cfg.alpha if cfg.no_soft else "soft"
    step_fn = make_balanced_batch_step(model, optimizer, cfg, margin)
    # the validation features go to the device once, not every epoch
    val_x = torch.from_numpy(exp.val_feats).to(device)
    # a config-seeded rng for the balanced selection: the same draws as the
    # JAX trainer's
    sel_rng = random.Random(cfg.seed)

    def selected():
        """One item per loader batch, across epochs: the balanced [B]
        selection, or None when the batch has no foreground class."""
        while True:
            produced = 0
            for b in exp.loader.epoch():
                produced += 1
                n = int(b["num_events"])
                idx = select_batch_balanced(b["labels"][:n], batch_size,
                                            rng=sel_rng)
                yield (None if idx.size == 0
                       else (b["events"][idx], b["labels"][idx]))
            if not produced:
                return

    metrics = {}
    stream = selected()
    try:
        epoch = epoch_of_step(step_host, exp.batch_per_epoch)
        while epoch < cfg.max_epochs:
            lr = learning_rate_schedule(epoch, cfg.learning_rate,
                                        cfg.static_epochs, cfg.max_epochs)
            step_at_epoch_start = step_host
            for batch in itertools.islice(stream, exp.batch_per_epoch):
                if batch is None:
                    continue  # no balanced batch in this loader draw
                events = torch.from_numpy(batch[0]).to(device)
                labels = torch.from_numpy(
                    batch[1].astype(np.int64)).to(device)
                aux = step_fn(events, labels, lr)
                step_host += 1
                exp.log_deferred(
                    step_host, aux, {"learning_rate": lr},
                    echo_fn=lambda sc, e=epoch, s=step_host: (
                        f"[{cfg.name}] epoch {e + 1} step {s} "
                        f"loss {sc['loss']:.4f}"))
            exp.flush_logs()
            if step_host == step_at_epoch_start:
                print(f"[{cfg.name}] epoch {epoch + 1}: no trainable batch; "
                      "stopping")
                break
            metrics, _ = validate(embed_fn, val_x, exp.val_labels, device,
                                  margin)
            exp.log(step_host, metrics,
                    f"[{cfg.name}] epoch {epoch + 1} val mAP "
                    f"{metrics['val_mAP']:.4f}")
            exp.ckpt.save(model, optimizer, step_host)
            epoch = epoch_of_step(step_host, exp.batch_per_epoch)
    finally:
        stream.close()  # cancels the loader's prefetch worker
        exp.close()
    return TrainResult(model, optimizer, step_host, metrics, exp.result_dir)


def main(argv=None):
    train(TrainConfig.parse(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
