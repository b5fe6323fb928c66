"""The epoch loop of the Honda budget-batch trainers (``pddm_model``,
``multitask_model``, ``multitask_dcca``, ``modality_hallucination``,
``cross_prediction``, ``base_model_classifier``, ``unimodal_pretrain_sae``
and their wrappers): the loader's batches uploaded on the feed thread
(data/device_feed.py), one step a batch with its scalars logged without a
per-step readback, then per epoch a validation and a checkpoint.  With
--device_cache (``cache_feed``) the batches are gathered on the device from
the feature cache inside each fused step instead (data/device_cache.py,
train/cached_steps.py); the loader is not read.  The feed is the
experiment's (``HondaExperiment.open_feed`` / ``run_epoch``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.train.cached_steps import (
    make_cached_body_step)
from multimodal_similarity_tpu_torch.train.state import (
    learning_rate_schedule)
from multimodal_similarity_tpu_torch.train.steps import make_embed_fn
from multimodal_similarity_tpu_torch.train.trainer import (
    epoch_of_step, validate)
from multimodal_similarity_tpu_torch.train.trainers._honda import (
    HondaExperiment)
from multimodal_similarity_tpu_torch.train.trainers.base_model_batchhard \
    import TrainResult


def loader_batches(exp: HondaExperiment):
    """Loader batches epoch after epoch, for the feed thread."""
    while True:
        produced = 0
        for b in exp.loader_epoch():
            produced += 1
            yield b
        if not produced:
            return


def retrieval_validation(encoder: nn.Module, cfg: TrainConfig,
                         exp: HondaExperiment, device: torch.device,
                         extra: Optional[Callable] = None
                         ) -> Callable[[], Dict[str, float]]:
    """The per-epoch validation of most trainers: the leave-one-out
    retrieval metrics (``val_mAP`` ...) of ``encoder`` on the validation
    set, uploaded once, plus ``extra(val_x)``."""
    embed_fn = make_embed_fn(encoder, cfg.normalized)
    val_x = torch.from_numpy(exp.val_feats).to(device)

    def run():
        metrics, _ = validate(embed_fn, val_x, exp.val_labels, device,
                              beat=exp.control.beat_fn)
        if extra is not None:
            metrics.update(extra(val_x))
        return metrics

    return run


def cache_feed(exp: HondaExperiment, cfg: TrainConfig, body: Callable,
               device: torch.device, modality_modes=None):
    """--device_cache for a budget trainer: (cache, fused step) with
    ``body(events, labels, mask, learning_rate)`` over the cache's gathered
    modalities (``make_cached_body_step``; the gather draws from
    ``cfg.seed + 4``), or None to stream (flag off, or over budget)."""
    cache = exp.build_cache(device, modality_modes=modality_modes)
    if cache is None:
        return None
    return cache, make_cached_body_step(
        body, cache, torch.Generator(device=device).manual_seed(cfg.seed + 4))


def run_budget_trainer(cfg: TrainConfig, exp: HondaExperiment,
                       model: nn.Module, optimizer, run: Callable,
                       device: torch.device, step_host: int,
                       validation: Callable[[], Dict[str, float]],
                       device_keys: Sequence[str] = ("events", "labels",
                                                     "mask"),
                       decay_base: float = 0.001,
                       echo_keys: Sequence[str] = (),
                       cached=None) -> TrainResult:
    """The loader's batches with ``device_keys`` uploaded on the feed
    thread; ``run(batch, epoch, learning_rate)`` a batch returns the step's
    device scalars, or None for a batch it skips; the scalars are logged
    without a per-step readback.  ``cached`` (``cache_feed``'s pair) runs
    each epoch through the fused cached step instead.  Per epoch,
    ``validation()`` gives the metrics logged and returned, and a
    checkpoint is saved.  Stops after an epoch without a step.  Closes the
    feed and ``exp``."""

    def echo(e, s, sc):
        return (f"[{cfg.name}] epoch {e + 1} step {s} "
                + " ".join(f"{k} {sc[k]:.4f}"
                           for k in ("loss",) + tuple(echo_keys)))

    metrics = {}
    exp.open_feed(device, loader_batches(exp), device_keys, cached=cached)
    try:
        epoch = epoch_of_step(step_host, exp.batch_per_epoch)
        while epoch < cfg.max_epochs:
            lr = learning_rate_schedule(epoch, cfg.learning_rate,
                                        cfg.static_epochs, cfg.max_epochs,
                                        decay_base=decay_base)
            step_at_epoch_start = step_host
            step_host = exp.run_epoch(
                lambda batch, lr_: run(batch, epoch, lr_), lr, step_host,
                epoch, echo)
            if exp.preempted(step_host, model, optimizer):
                break
            if step_host == step_at_epoch_start:
                print(f"[{cfg.name}] epoch {epoch + 1}: no trainable batch; "
                      "stopping")
                break
            metrics = validation()
            exp.log(step_host, metrics,
                    f"[{cfg.name}] epoch {epoch + 1} "
                    + " ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
            exp.save(model, optimizer, step_host)
            epoch = epoch_of_step(step_host, exp.batch_per_epoch)
    finally:
        exp.close()
    return TrainResult(model, optimizer, step_host, metrics, exp.result_dir)
