"""Batch-hard trainer on class-balanced batches.

Round-robin class-balanced batches from the session loader, the encoder,
l2-normalisation, and a batch-structured objective through fused CUDA
kernels: batch-hard ("In Defense of the Triplet Loss",
ops/kernels/batch_hard.py) or, with ``loss_kind="lifted"``, the
lifted-structured loss (ops/kernels/lifted.py; base_model_lifted.py).  Adam
(eps=0.1), per-epoch leave-one-out validation and a checkpoint.  Single
device: more than one visible GPU is not sharded.  Streamed, the balanced
selection, its row gather, the --bf16_features cast or --int8_features
quantizing and the upload run on the feed thread, two batches ahead
(data/device_feed.py).  With --device_cache the train windows stay on the
device as int8 (data/device_cache.py): the balanced selection runs on each
plan's host labels, and one fused step gathers the selected rows' TSN
frames and trains (``make_cached_balanced_step``); --steps_per_dispatch K
issues K such steps back to back (train/cached_steps.py).

Run:  python -m multimodal_similarity_tpu_torch.train.trainers.base_model_batchhard --DATA_ROOT <dir> ...
(``--device cpu`` runs on the CPU; the default is ``cuda``.)
"""

from __future__ import annotations

import argparse
import random
import sys
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from multimodal_similarity_tpu_torch import resolve_device
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.data.device_feed import (
    dequant_features, feature_keys)
from multimodal_similarity_tpu_torch.models import build_encoder
from multimodal_similarity_tpu_torch.ops.kernels import (
    batch_hard_fused, lifted_loss_fused)
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


def _check_supported(cfg: TrainConfig, no_cache: Optional[str] = None
                     ) -> None:
    """Raise for every option whose feature is not ported yet, naming the
    ROADMAP slice that ports it.  ``no_cache`` names a trainer that has no
    cached feed in the JAX package either (which streams there silently):
    --device_cache raises ValueError on it (ROADMAP D5)."""
    if no_cache and cfg.device_cache:
        raise ValueError(f"--device_cache: {no_cache} has no cached feed")
    unported = (
        (cfg.multihost, "--multihost", "8c"),
        (cfg.model_parallel > 1, "--model_parallel", "8c"),
        (bool(cfg.profile_dir), "--profile_dir", "8b"),
        (cfg.watchdog_secs > 0, "--watchdog_secs", "8b"),
    )
    for is_set, flag, slice_no in unported:
        if is_set:
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP slice {slice_no})")


def make_loss(cfg: TrainConfig, loss_kind: str,
              precision: Optional[str] = None) -> Callable:
    """loss(emb, labels) -> the loss tuple of the trainer's objective.

    Batch-hard: the soft margin unless ``--no_soft`` (then ``alpha``), bf16
    stats.  Lifted: margin ``alpha``, f32 stats (the JAX default for
    lifted), and the triangular bounded forward when the embeddings are
    l2-normalised.  ``precision`` overrides the kind's default."""
    if loss_kind == "batchhard":
        margin = cfg.alpha if cfg.no_soft else "soft"
        prec = precision or "bf16"
        return lambda emb, labels: batch_hard_fused(
            emb, labels, margin, weighted=True, precision=prec)
    if loss_kind == "lifted":
        prec = precision or "f32"
        return lambda emb, labels: lifted_loss_fused(
            emb, labels, cfg.alpha, weighted=True, precision=prec,
            bounded=cfg.normalized)
    raise ValueError(f"unknown loss_kind {loss_kind!r}; expected "
                     "'batchhard' or 'lifted'")


def make_balanced_batch_step(model, optimizer, cfg: TrainConfig,
                             loss_kind: str = "batchhard",
                             precision: Optional[str] = None):
    """step(events [B, ...], labels [B], learning_rate) -> device scalars,
    one optimizer step of the ``loss_kind`` objective over a class-balanced
    batch; ``events`` dense or the int8 feed's {"q", "scale"}."""
    loss_fn = make_loss(cfg, loss_kind, precision)

    def step(events, labels: torch.Tensor, learning_rate: float):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        emb = model(dequant_features(events))
        if cfg.normalized:
            emb = l2_normalize(emb)
        loss, num_active, *_ = loss_fn(emb, labels)
        total = loss
        if cfg.lambda_l2:
            total = total + cfg.lambda_l2 * l2_regularization(model)
        total.backward()
        apply_gradients(optimizer, learning_rate)
        return {"loss": total.detach(), "metric_loss": loss.detach(),
                "active_count": num_active.detach()}

    return step


def make_cached_balanced_step(model, optimizer, cfg: TrainConfig, cache,
                              generator: torch.Generator,
                              loss_kind: str = "batchhard"):
    """The fused cached step: step(plan, learning_rate) -> device scalars,
    ``plan`` a cache plan followed by the balanced rows it selects
    (``cached_selections``), on the device.  Only the selected rows' TSN
    frames are gathered (their uniforms drawn for the whole plan, from
    ``generator``), then the ``loss_kind`` step of
    ``make_balanced_batch_step``."""
    inner = make_balanced_batch_step(model, optimizer, cfg, loss_kind)
    cut = cache.event_budget + 1

    def step(plan: torch.Tensor, learning_rate: float):
        gathered, labels, _ = cache.gather(plan[:cut], generator,
                                           rows=plan[cut:].long())
        return inner(gathered[0], labels, learning_rate)

    return step


def cached_selections(cache, batch_size: int, sel_rng: random.Random):
    """One epoch of the cache's plans with their balanced [B] selection
    appended (int32), skipping plans with no foreground class: the
    selection runs on the plan's host labels."""
    out = []
    for plan in cache.epoch_plans():
        valid = np.where(plan["mask_host"] > 0)[0]
        idx = select_batch_balanced(plan["labels_host"][valid], batch_size,
                                    rng=sel_rng)
        if idx.size:
            out.append(np.concatenate([plan["packed"],
                                       valid[idx].astype(np.int32)]))
    return out


def balanced_batches(exp: HondaExperiment, batch_size: int,
                     sel_rng: random.Random):
    """One item per loader batch, across epochs, for the feed thread (so
    the draws stay in loader order): the batch with its balanced [B]
    selection as ``rows``, or None when it has no foreground class."""
    while True:
        produced = 0
        for b in exp.loader.epoch():
            produced += 1
            n = int(b["num_events"])
            idx = select_batch_balanced(b["labels"][:n], batch_size,
                                        rng=sel_rng)
            yield (None if idx.size == 0 else
                   {"events": b["events"], "labels": b["labels"],
                    "rows": idx})
        if not produced:
            return


def train(cfg: TrainConfig, loss_kind: str = "batchhard",
          event_budget: Optional[int] = None,
          result_dir: Optional[str] = None, device=None) -> TrainResult:
    """Train on ``device`` (default ``cuda``; raises when no card is
    visible and the CPU was not asked for)."""
    # the validation loss is the trainer's own objective; an unknown loss
    # kind raises here, before any data is read
    val_loss_fn = make_loss(cfg, loss_kind)
    _check_supported(cfg)
    device = resolve_device(device)
    exp = HondaExperiment(cfg, event_budget=event_budget,
                          result_dir=result_dir, supports_int8=True)
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
    step_fn = make_balanced_batch_step(model, optimizer, cfg, loss_kind)
    # the validation features go to the device once, not every epoch
    val_x = torch.from_numpy(exp.val_feats).to(device)
    # a config-seeded rng for the balanced selection: the same draws as the
    # JAX trainer's
    sel_rng = random.Random(cfg.seed)

    # --device_cache: the train windows stay on the device; a step is one
    # plan upload and one fused gather + train (None: stream)
    cache = exp.build_cache(device)
    cached = None if cache is None else (cache, make_cached_balanced_step(
        model, optimizer, cfg, cache,
        torch.Generator(device=device).manual_seed(cfg.seed + 3), loss_kind))

    def echo(e, s, sc):
        return f"[{cfg.name}] epoch {e + 1} step {s} loss {sc['loss']:.4f}"

    def run(batch, lr):
        return step_fn(batch["events"], batch["labels"], lr)

    metrics = {}
    exp.open_feed(device, balanced_batches(exp, batch_size, sel_rng),
                  ("events", "labels"), cached=cached,
                  plans=lambda: cached_selections(cache, batch_size, sel_rng),
                  **feature_keys(cfg))
    try:
        epoch = epoch_of_step(step_host, exp.batch_per_epoch)
        while epoch < cfg.max_epochs:
            lr = learning_rate_schedule(epoch, cfg.learning_rate,
                                        cfg.static_epochs, cfg.max_epochs)
            step_at_epoch_start = step_host
            step_host = exp.run_epoch(run, lr, step_host, epoch, echo)
            if step_host == step_at_epoch_start:
                print(f"[{cfg.name}] epoch {epoch + 1}: no trainable batch; "
                      "stopping")
                break
            metrics, _ = validate(embed_fn, val_x, exp.val_labels, device,
                                  val_loss_fn)
            exp.log(step_host, metrics,
                    f"[{cfg.name}] epoch {epoch + 1} val mAP "
                    f"{metrics['val_mAP']:.4f}")
            exp.ckpt.save(model, optimizer, step_host)
            epoch = epoch_of_step(step_host, exp.batch_per_epoch)
    finally:
        exp.close()
    return TrainResult(model, optimizer, step_host, metrics, exp.result_dir)


def main(argv=None, loss_kind: str = "batchhard"):
    """The trainer CLI: the JAX trainer's flags, plus ``--device`` (default
    ``cuda``)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default=None)
    args, rest = p.parse_known_args(argv)
    train(TrainConfig.parse(rest), loss_kind=loss_kind, device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
