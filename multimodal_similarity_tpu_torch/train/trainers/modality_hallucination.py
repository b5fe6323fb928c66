"""Modality-hallucination trainer (``scripts/train_hallucination.sh``).

Learning with side information: hallucination branches map the video
features into the sensors and segment embedding spaces.  Five encoders,
all trained, in the JAX trainer's scope names: the core video encoder
(``modality_core``), the sensors and segment RTSN towers of emb_dim 32
(``modality_sensors``, ``modality_segment``, with dropout), and two more
video encoders of emb_dim 32 (``hallucination_sensors``,
``hallucination_segment``).  Each loader batch: facenet triplets mined over
all its events on the core embeddings; one step on six masked triplet
losses (core, sensors, hallucinated sensors, segment, hallucinated
segment, and the core and hallucinated embeddings concatenated) plus
``lambda_multimodal`` x the l2 match 0.5 sum((real - hallucinated)^2) of
each real and hallucinated pair.  ``sensors_only`` (the weak variant)
drops the segment branches and fuses core and hallucinated sensors, with
``lambda_metric`` / ``lambda_hal`` scaling the two terms.

The modalities go up on the feed thread (data/device_feed.py); the mined
rows are gathered on the device; labels stay on the host for the NumPy
miner.  Single device; no CUDA kernel of ``csrc/`` is on this path.

Run:  python -m multimodal_similarity_tpu_torch.train.trainers.modality_hallucination --DATA_ROOT <dir> --feat resnet,sensors,segment --lambda_multimodal 0.1 ...
(``--device cpu`` runs on the CPU; the default is ``cuda``.)
"""

from __future__ import annotations

import argparse
import random
import sys
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from multimodal_similarity_tpu_torch import resolve_device
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.models import (
    BRANCH_EMB_DIM, RTSN, build_encoder)
from multimodal_similarity_tpu_torch.ops.distances import cdist_rows
from multimodal_similarity_tpu_torch.ops.losses import triplet_loss_masked
from multimodal_similarity_tpu_torch.ops.mining import select_triplets_facenet
from multimodal_similarity_tpu_torch.train.checkpoints import load_checkpoint
from multimodal_similarity_tpu_torch.train.state import (
    apply_gradients, build_optimizer, l2_regularization)
from multimodal_similarity_tpu_torch.train.steps import (
    embed_in_chunks, l2_normalize, make_embed_fn)
from multimodal_similarity_tpu_torch.train.trainers._honda import (
    HondaExperiment)
from multimodal_similarity_tpu_torch.train.trainers._loop import (
    retrieval_validation, run_budget_trainer)
from multimodal_similarity_tpu_torch.train.trainers.base_model_batchhard \
    import TrainResult, _check_supported
from multimodal_similarity_tpu_torch.train.trainers.multimodal_model import (
    restore_branch)


def build_model(cfg: TrainConfig, device: torch.device, sensors_dim: int,
                segment_dim: Optional[int] = None) -> nn.ModuleDict:
    """``modality_core``, ``modality_sensors`` and
    ``hallucination_sensors``, and with ``segment_dim`` also
    ``modality_segment`` and ``hallucination_segment``, in that order:
    weights drawn from ``cfg.seed``, every dropout mask from ``cfg.seed +
    1``."""
    init_gen = torch.Generator().manual_seed(cfg.seed)
    rngs = dict(keep_prob=cfg.keep_prob, generator=init_gen,
                dropout_generator=torch.Generator(device=device).manual_seed(
                    cfg.seed + 1))

    def video(emb_dim):
        return build_encoder(cfg.network, num_seg=cfg.num_seg,
                             emb_dim=emb_dim, n_input=cfg.n_input,
                             n_h=cfg.n_h, n_w=cfg.n_w, n_C=cfg.n_C, **rngs)

    mods = {"modality_core": video(cfg.emb_dim),
            "modality_sensors": RTSN(n_seg=cfg.num_seg,
                                     emb_dim=BRANCH_EMB_DIM,
                                     n_input=sensors_dim, **rngs),
            "hallucination_sensors": video(BRANCH_EMB_DIM)}
    if segment_dim is not None:
        mods["modality_segment"] = RTSN(n_seg=cfg.num_seg,
                                        emb_dim=BRANCH_EMB_DIM,
                                        n_input=segment_dim, **rngs)
        mods["hallucination_segment"] = video(BRANCH_EMB_DIM)
    return nn.ModuleDict(mods).to(device)


def make_hallucination_step(model: nn.ModuleDict, optimizer, cfg: TrainConfig,
                            lambda_metric: float = 1.0,
                            lambda_hal: float = 1.0) -> Callable:
    """step(tri_events, tri_sensors, tri_segment, mask, learning_rate) ->
    device scalars; the rows in [a, p, n, a, p, n, ...] order
    (``tri_segment`` None without the segment branches)."""
    segment = "modality_segment" in model

    def emb(scope, x):
        e = model[scope](x)
        return l2_normalize(e) if cfg.normalized else e

    def step(tri_events, tri_sensors, tri_segment, mask,
             learning_rate: float):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        tri_cap = mask.shape[0]
        # each row's triplet mask: the rows run triplet-major, a triplet's
        # three roles in a row (repeat_interleave, not a tiled repeat)
        row_mask = mask.repeat_interleave(3)[:, None]

        def split(e):
            t = e.reshape(tri_cap, 3, -1)
            return t[:, 0], t[:, 1], t[:, 2]

        def tri_loss(parts):
            return triplet_loss_masked(*parts, mask, cfg.alpha)

        emb_c = emb("modality_core", tri_events)
        emb_s = emb("modality_sensors", tri_sensors)
        emb_hs = emb("hallucination_sensors", tri_events)
        core, sens, hal_s = split(emb_c), split(emb_s), split(emb_hs)
        metric = tri_loss(core) + tri_loss(sens) + tri_loss(hal_s)
        hal = 0.5 * ((emb_s - emb_hs) ** 2 * row_mask).sum()
        fused = [core, hal_s]
        if segment:
            emb_g = emb("modality_segment", tri_segment)
            emb_hg = emb("hallucination_segment", tri_events)
            hal_g = split(emb_hg)
            metric = metric + tri_loss(split(emb_g)) + tri_loss(hal_g)
            hal = hal + 0.5 * ((emb_g - emb_hg) ** 2 * row_mask).sum()
            fused.append(hal_g)
        metric = metric + tri_loss(
            [torch.cat(roles, dim=1) for roles in zip(*fused)])
        total = (lambda_metric * metric
                 + lambda_hal * cfg.lambda_multimodal * hal)
        if cfg.lambda_l2:
            total = total + cfg.lambda_l2 * l2_regularization(model)
        total.backward()
        apply_gradients(optimizer, learning_rate)
        return {"loss": total.detach(), "metric_loss": metric.detach(),
                "hal_loss": hal.detach()}

    return step


def make_host_step(model: nn.ModuleDict, optimizer, cfg: TrainConfig,
                   device: torch.device, mine_rng: random.Random,
                   lambda_metric: float = 1.0,
                   lambda_hal: float = 1.0) -> Callable:
    """run(batch, learning_rate) -> the step's device scalars, or None when
    the facenet miner finds no triplet among the batch's events.  The
    batch's modalities are on ``device``, its labels on the host; the core
    distances of all its events are read back for the NumPy miner."""
    tri_cap = 2 * cfg.triplet_per_batch
    core_embed = make_embed_fn(model["modality_core"], cfg.normalized)
    step = make_hallucination_step(model, optimizer, cfg, lambda_metric,
                                   lambda_hal)

    def run(batch, learning_rate: float):
        n = int(batch["num_events"])
        emb = embed_in_chunks(core_embed, batch["events"][:n], device)
        idx, _ = select_triplets_facenet(
            batch["labels"][:n], cdist_rows(emb, emb, cfg.metric).cpu()
            .numpy(), cfg.triplet_per_batch, cfg.alpha, cfg.num_negative,
            rng=mine_rng)
        if not idx:
            return None
        t = min(len(idx) // 3, tri_cap)
        gather = np.zeros(3 * tri_cap, np.int64)
        gather[: 3 * t] = np.asarray(idx[: 3 * t], np.int64)
        mask = np.zeros(tri_cap, np.float32)
        mask[:t] = 1.0
        rows = torch.from_numpy(gather).to(device)
        return step(batch["events"].index_select(0, rows),
                    batch["events2"].index_select(0, rows),
                    (batch["events3"].index_select(0, rows)
                     if "events3" in batch else None),
                    torch.from_numpy(mask).to(device), learning_rate)

    return run


def train(cfg: TrainConfig, sensors_only: bool = False,
          lambda_metric: float = 1.0, lambda_hal: float = 1.0,
          event_budget: Optional[int] = None,
          result_dir: Optional[str] = None, device=None) -> TrainResult:
    """Train on ``device`` (default ``cuda``; raises when no card is
    visible and the CPU was not asked for).  ``--model_path`` restores a
    port checkpoint (weights, optimizer state and step); the JAX trainer
    has no such restore."""
    _check_supported(cfg, ("modality_hallucination_weak" if sensors_only
                           else "modality_hallucination"), no_cache=True)
    device = resolve_device(device)
    modalities = ["resnet", "sensors"] + ([] if sensors_only
                                          else ["segment"])
    exp = HondaExperiment(cfg, modalities=modalities,
                          event_budget=event_budget, result_dir=result_dir)
    model = build_model(cfg, device, exp.val_extra[0].shape[-1],
                        None if sensors_only else exp.val_extra[1].shape[-1])
    for scope, path in (("modality_sensors", cfg.sensors_path),
                        ("modality_segment", cfg.segment_path)):
        if path and scope in model:
            restore_branch(model[scope], path, subkey="encoder")
    optimizer = build_optimizer(cfg.optimizer, model, cfg.learning_rate)
    step_host = 0
    if cfg.model_path:
        step_host = load_checkpoint(cfg.model_path, model, optimizer)

    # config-seeded host-miner stream: the JAX trainer's draws
    run = make_host_step(model, optimizer, cfg, device,
                         random.Random(cfg.seed), lambda_metric, lambda_hal)
    keys = ("events", "events2") + (() if sensors_only else ("events3",))
    return run_budget_trainer(
        cfg, exp, model, optimizer, lambda batch, epoch, lr: run(batch, lr),
        device, step_host,
        retrieval_validation(model["modality_core"], cfg, exp, device),
        device_keys=keys, echo_keys=("metric_loss", "hal_loss"))


def main(argv=None, sensors_only: bool = False):
    """The trainer CLI: the JAX trainer's flags, plus ``--device`` (default
    ``cuda``)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default=None)
    args, rest = p.parse_known_args(argv)
    train(TrainConfig.parse(rest), sensors_only=sensors_only,
          device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
