"""Triplet + Deep-CCA multitask trainer (``scripts/train_multitask_dcca.sh``).

Facenet triplets mined among the events of labeled sessions drive the
triplet loss of the core video encoder (``modality_core``); a random
unsupervised slice of each batch drives the DCCA correlation losses core
<-> sensors and core <-> segment, computed on frozen RTSN towers of emb_dim
32 (``modality_sensors`` / ``modality_segment``, restored from
``pddm_model`` checkpoints through ``--sensors_path`` / ``--segment_path``).
The loss is ``metric_loss + mul_loss * lambda_mul``, with ``lambda_mul``
``--lambda_multimodal`` from epoch ``--multimodal_epochs`` on and 0 before.
``use_mse=True`` is the cross-prediction variant
(``multitask_cross_prediction.py``): two ``OutputLayer`` heads
(``modality_core_heads``) regress the frozen sensors and segment
embeddings from relu(core embedding) with an MSE.

The three modalities go up on the feed thread (data/device_feed.py); the
triplet and unsupervised rows are gathered on the device from index
tensors; labels and session ids stay on the host for the NumPy facenet
miner, which reads back the labeled slice's distances.  Single device; no
CUDA kernel of ``csrc/`` is on this path (the DCCA loss runs
``torch.linalg.eigh`` and ``svdvals``).

Run:  python -m multimodal_similarity_tpu_torch.train.trainers.multitask_dcca --DATA_ROOT <dir> --feat resnet,sensors,segment --sensors_path <ckpt> --segment_path <ckpt> ...
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
    BRANCH_EMB_DIM, RTSN, OutputLayer, build_encoder)
from multimodal_similarity_tpu_torch.ops.distances import cdist_rows
from multimodal_similarity_tpu_torch.ops.losses import (
    dcca_loss, triplet_loss_masked)
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

FROZEN = ("modality_sensors", "modality_segment")


def build_model(cfg: TrainConfig, device: torch.device, sensors_dim: int,
                segment_dim: int, use_mse: bool = False) -> nn.ModuleDict:
    """The core encoder of ``cfg`` (``modality_core``), the sensors and
    segment RTSN towers (emb_dim 32, no dropout), and under ``use_mse``
    the two ``OutputLayer`` heads (``modality_core_heads``), in the JAX
    trainer's scope names.  Weights are drawn from ``cfg.seed`` in that
    order; the dropout masks of the core and the heads from ``cfg.seed +
    1``."""
    init_gen = torch.Generator().manual_seed(cfg.seed)
    drop_gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    mods = {
        "modality_core": build_encoder(
            cfg.network, num_seg=cfg.num_seg, emb_dim=cfg.emb_dim,
            n_input=cfg.n_input, n_h=cfg.n_h, n_w=cfg.n_w, n_C=cfg.n_C,
            keep_prob=cfg.keep_prob, generator=init_gen,
            dropout_generator=drop_gen),
        "modality_sensors": RTSN(n_seg=cfg.num_seg, emb_dim=BRANCH_EMB_DIM,
                                 n_input=sensors_dim, generator=init_gen),
        "modality_segment": RTSN(n_seg=cfg.num_seg, emb_dim=BRANCH_EMB_DIM,
                                 n_input=segment_dim, generator=init_gen)}
    if use_mse:
        mods["modality_core_heads"] = nn.ModuleDict({
            name: OutputLayer(cfg.emb_dim, dim, keep_prob=cfg.keep_prob,
                              generator=init_gen, dropout_generator=drop_gen)
            for name, dim in (("sensors", BRANCH_EMB_DIM),
                              ("segment", BRANCH_EMB_DIM))})
    return nn.ModuleDict(mods).to(device)


def make_dcca_step(model: nn.ModuleDict, optimizer, cfg: TrainConfig,
                   use_mse: bool = False) -> Callable:
    """step(tri_events, tri_mask, unsup_events, unsup_sensors,
    unsup_segment, lambda_mul, learning_rate) -> device scalars.

    Train-mode core forwards of the [a, p, n, ...] triplet rows and of the
    unsupervised rows; the frozen towers embed the unsupervised sensors and
    segment rows without gradient.  ``mul_loss`` is computed at every step,
    also when ``lambda_mul`` is 0, so that the heads of the MSE variant
    always take a (zero) gradient and Adam steps them, as optax does."""
    core = model["modality_core"]

    def emb(module, x):
        e = module(x)
        return l2_normalize(e) if cfg.normalized else e

    def step(tri_events, tri_mask, unsup_events, unsup_sensors,
             unsup_segment, lambda_mul: float, learning_rate: float):
        core.train()
        optimizer.zero_grad(set_to_none=True)
        tri = emb(core, tri_events).reshape(tri_mask.shape[0], 3, -1)
        metric_loss = triplet_loss_masked(tri[:, 0], tri[:, 1], tri[:, 2],
                                          tri_mask, cfg.alpha)
        emb_u = emb(core, unsup_events)
        with torch.no_grad():
            emb_s = emb(model["modality_sensors"], unsup_sensors)
            emb_g = emb(model["modality_segment"], unsup_segment)
        if use_mse:
            heads = model["modality_core_heads"]
            heads.train()
            hidden = torch.relu(emb_u)
            mul_loss = (((emb_s - heads["sensors"](hidden)) ** 2).mean()
                        / BRANCH_EMB_DIM
                        + ((emb_g - heads["segment"](hidden)) ** 2).mean()
                        / BRANCH_EMB_DIM)
        else:
            mul_loss = dcca_loss(emb_u, emb_s) + dcca_loss(emb_u, emb_g)
        total = metric_loss + mul_loss * lambda_mul
        if cfg.lambda_l2:
            total = total + cfg.lambda_l2 * l2_regularization(model)
        total.backward()
        apply_gradients(optimizer, learning_rate)
        return {"loss": total.detach(), "metric_loss": metric_loss.detach(),
                "mul_loss": mul_loss.detach()}

    return step


def make_host_step(model: nn.ModuleDict, optimizer, cfg: TrainConfig,
                   device: torch.device, labeled_sessions,
                   mine_rng: random.Random, unsup_rng: np.random.RandomState,
                   unsup_cap: int, use_mse: bool = False) -> Callable:
    """run(batch, learning_rate, lambda_mul) -> the step's device scalars,
    or None for a batch skipped (no triplet and ``lambda_mul`` 0).  The
    batch's modalities are on ``device``, its labels and sessions on the
    host.  The facenet miner runs on the host over the labeled events'
    distances (read back); the unsupervised slice is ``unsup_cap`` events
    of a ``unsup_rng`` permutation, topped up with replacement when the
    batch is short (zero padding would corrupt the DCCA covariances), the
    JAX trainer's draws."""
    tri_cap = 2 * cfg.triplet_per_batch
    core_embed = make_embed_fn(model["modality_core"], cfg.normalized)
    step = make_dcca_step(model, optimizer, cfg, use_mse)

    def rows(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(device)

    def run(batch, learning_rate: float, lambda_mul: float):
        n = int(batch["num_events"])
        labels = batch["labels"][:n]
        lab_map = np.where(np.asarray(
            [s in labeled_sessions for s in batch["sessions"][:n]],
            bool))[0]
        events = batch["events"]
        gather = np.zeros(3 * tri_cap, np.int64)
        tri_mask = np.zeros(tri_cap, np.float32)
        if lab_map.size:
            emb = embed_in_chunks(core_embed,
                                  events.index_select(0, rows(lab_map)),
                                  device)
            idx, _ = select_triplets_facenet(
                labels[lab_map], cdist_rows(emb, emb, cfg.metric).cpu()
                .numpy(), cfg.triplet_per_batch, cfg.alpha,
                cfg.num_negative, rng=mine_rng)
            t = min(len(idx) // 3, tri_cap)
            if t:
                gather[: 3 * t] = lab_map[np.asarray(idx[: 3 * t], np.int64)]
                tri_mask[:t] = 1.0
        if not tri_mask.any() and lambda_mul == 0.0:
            return None
        perm = unsup_rng.permutation(n)[:unsup_cap]
        if perm.size < unsup_cap:
            extra = unsup_rng.randint(0, n, size=unsup_cap - perm.size)
            perm = np.concatenate([perm, extra])
        u_idx = rows(perm)
        return step(events.index_select(0, rows(gather)),
                    torch.from_numpy(tri_mask).to(device),
                    events.index_select(0, u_idx),
                    batch["events2"].index_select(0, u_idx),
                    batch["events3"].index_select(0, u_idx),
                    lambda_mul, learning_rate)

    return run


def train(cfg: TrainConfig, use_mse: bool = False,
          event_budget: Optional[int] = None,
          result_dir: Optional[str] = None, device=None) -> TrainResult:
    """Train on ``device`` (default ``cuda``; raises when no card is
    visible and the CPU was not asked for).  ``--model_path`` restores a
    port checkpoint (weights, optimizer state and step); the JAX trainer
    has no such restore."""
    _check_supported(cfg, ("multitask_cross_prediction" if use_mse
                           else "multitask_dcca"), no_cache=True)
    device = resolve_device(device)
    modalities = cfg.feat if isinstance(cfg.feat, list) and \
        len(cfg.feat) == 3 else ["resnet", "sensors", "segment"]
    exp = HondaExperiment(cfg, modalities=modalities,
                          event_budget=event_budget, result_dir=result_dir,
                          limit_label_num=False)
    model = build_model(cfg, device, exp.val_extra[0].shape[-1],
                        exp.val_extra[1].shape[-1], use_mse)
    for scope, path in zip(FROZEN, (cfg.sensors_path, cfg.segment_path)):
        if path:
            restore_branch(model[scope], path, subkey="encoder")
    # only the core (and the MSE heads) train
    optimizer = build_optimizer(cfg.optimizer, model, cfg.learning_rate,
                                frozen_scopes=FROZEN)
    step_host = 0
    if cfg.model_path:
        step_host = load_checkpoint(cfg.model_path, model, optimizer)

    unsup_cap = min(3 * cfg.triplet_per_batch, exp.event_budget)
    # config-seeded host streams (miner, unsupervised slice): the JAX
    # trainer's draws
    run = make_host_step(model, optimizer, cfg, device, exp.labeled_sessions,
                         random.Random(cfg.seed),
                         np.random.RandomState(cfg.seed), unsup_cap, use_mse)
    return run_budget_trainer(
        cfg, exp, model, optimizer,
        lambda batch, epoch, lr: run(
            batch, lr, cfg.lambda_multimodal
            if epoch >= cfg.multimodal_epochs else 0.0),
        device, step_host,
        retrieval_validation(model["modality_core"], cfg, exp, device),
        device_keys=("events", "events2", "events3"), decay_base=0.01,
        echo_keys=("metric_loss", "mul_loss"))


def main(argv=None, use_mse: bool = False):
    """The trainer CLI: the JAX trainer's flags, plus ``--device`` (default
    ``cuda``)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default=None)
    args, rest = p.parse_known_args(argv)
    train(TrainConfig.parse(rest), use_mse=use_mse, device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
