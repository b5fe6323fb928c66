"""Weak / semi-supervised multimodal trainer.

Two objectives a loader batch, each its own optimizer step: facenet
triplets mined among the events of labeled sessions drive a plain triplet
loss; triplets mined purely from the sensors branch's PDDM
pseudo-similarities drive the triplet loss plus ``lambda_multimodal`` x the
weighted triplet loss, whose 4-way weights are the PDDM probabilities of
the triplet's pairs (these carry gradient into the sensors branch unless
``--no_joint`` freezes it).  ``--multimodal_select`` picks the
pseudo-triplets: ``confidence``, ``random`` or ``nopos``.  The resnet and
sensors modalities go up on the feed thread; labels and session ids stay
on the host for the NumPy miners.  Single device; no CUDA kernel of
``csrc/`` is on this path.

Run:  python -m multimodal_similarity_tpu_torch.train.trainers.multimodal_model_weak --DATA_ROOT <dir> --feat resnet,sensors --sensors_path <ckpt> ...
(``--device cpu`` runs on the CPU; the default is ``cuda``.)
"""

from __future__ import annotations

import argparse
import itertools
import random
import sys
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from multimodal_similarity_tpu_torch import resolve_device
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.data.device_feed import device_prefetch
from multimodal_similarity_tpu_torch.models import score_all_pairs_sym
from multimodal_similarity_tpu_torch.ops.distances import cdist_rows
from multimodal_similarity_tpu_torch.ops.losses import (
    triplet_loss_masked, weighted_triplet_loss_per_triplet)
from multimodal_similarity_tpu_torch.ops.mining import select_triplets_facenet
from multimodal_similarity_tpu_torch.train.checkpoints import load_checkpoint
from multimodal_similarity_tpu_torch.train.state import (
    apply_gradients, build_optimizer, l2_regularization,
    learning_rate_schedule)
from multimodal_similarity_tpu_torch.train.steps import (
    embed_in_chunks, l2_normalize, make_embed_fn)
from multimodal_similarity_tpu_torch.train.trainer import (
    epoch_of_step, validate)
from multimodal_similarity_tpu_torch.train.trainers._honda import (
    HondaExperiment)
from multimodal_similarity_tpu_torch.train.trainers._loop import (
    loader_batches)
from multimodal_similarity_tpu_torch.train.trainers.base_model_batchhard \
    import TrainResult, _check_supported
from multimodal_similarity_tpu_torch.train.trainers.multimodal_model import (
    build_model, restore_branch)

SELECTORS = ("confidence", "random", "nopos")


def select_triplets_multimodal(sim_prob, threshold=0.8, max_num=1000,
                               rng=None):
    """High-confidence pseudo-label triplets, a copy of the JAX package's
    (anchors in random order, indices in the original space)."""
    rng = rng or np.random
    mul_idx: List[int] = []
    count = 0
    for i in rng.permutation(sim_prob.shape[0]):
        row = sim_prob[i]
        pos_idx = np.where(row > threshold)[0]
        neg_idx = np.where(row < (1 - threshold))[0]
        if len(pos_idx) and len(neg_idx):
            neg_idx = np.argsort(row)[: len(pos_idx)]
            high_confidence = np.hstack((pos_idx, neg_idx))
            rng.shuffle(high_confidence)
            for pair in itertools.combinations(high_confidence, 2):
                mul_idx.extend([i, pair[0], pair[1]])
                count += 1
                if count == max_num:
                    return mul_idx, count
    return mul_idx, count


def random_triplets_multimodal(sim_prob, max_num=1000, rng=None):
    """Random pseudo-triplets from rows with more than one positive, a copy
    of the JAX package's."""
    rng = rng or np.random
    pos_rows = np.where(np.sum(sim_prob > 0.5, axis=1) > 1)[0]
    rng.shuffle(pos_rows)
    mul_idx: List[int] = []
    count = 0
    for i in pos_rows:
        pos_idx = np.where(sim_prob[i] > 0.5)[0]
        neg_idx = np.where(sim_prob[i] < 0.5)[0]
        rng.shuffle(neg_idx)
        neg_idx = neg_idx[: len(pos_idx)]
        idx = np.hstack((pos_idx, neg_idx))
        rng.shuffle(idx)
        perm2 = itertools.permutations(idx, 2)
        for _ in range(int(np.ceil(max_num / max(len(pos_rows), 1)))):
            try:
                pair = next(perm2)
            except StopIteration:
                break
            mul_idx.extend([i, pair[0], pair[1]])
            count += 1
            if count == max_num:
                return mul_idx, count
    return mul_idx, count


def nopos_triplets_multimodal(sim_prob, max_num=1000, rng=None):
    """Random pseudo-triplets without the positive-row constraint, a copy
    of the JAX package's."""
    rng = rng or np.random
    mul_idx: List[int] = []
    count = 0
    for i in rng.permutation(sim_prob.shape[0]):
        pos_idx = np.where(sim_prob[i] > 0.5)[0]
        neg_idx = np.where(sim_prob[i] < 0.5)[0]
        rng.shuffle(neg_idx)
        if len(pos_idx):
            neg_idx = neg_idx[: len(pos_idx)]
            idx = np.hstack((pos_idx, neg_idx))
        else:
            idx = neg_idx[:8]
        rng.shuffle(idx)
        perm2 = itertools.permutations(idx, 2)
        for _ in range(int(np.ceil(max_num / sim_prob.shape[0]))):
            try:
                pair = next(perm2)
            except StopIteration:
                break
            mul_idx.extend([i, pair[0], pair[1]])
            count += 1
            if count == max_num:
                return mul_idx, count
    return mul_idx, count


def _core_triplets(model: nn.Module, cfg: TrainConfig,
                   tri_events: torch.Tensor, tri_cap: int) -> torch.Tensor:
    core = model["modality_core"]
    core.train()
    emb = core(tri_events)
    if cfg.normalized:
        emb = l2_normalize(emb)
    return emb.reshape(tri_cap, 3, -1)


def _finish(model: nn.Module, optimizer, cfg: TrainConfig, loss,
            learning_rate: float) -> torch.Tensor:
    total = loss
    if cfg.lambda_l2:
        total = total + cfg.lambda_l2 * l2_regularization(model)
    total.backward()
    # every parameter takes the step, as under optax: one outside this
    # step's graph (the sensors branch in the labeled step) gets a zero
    # gradient, so its Adam moments and step count move with the rest
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    apply_gradients(optimizer, learning_rate)
    return total.detach()


def make_weak_steps(model: nn.Module, optimizer,
                    cfg: TrainConfig) -> Tuple[Callable, Callable]:
    """(uni_step(tri_events, mask, lr), mm_step(tri_events, tri_sensors,
    mask, lr)) -> device scalars: the labeled triplet step and the
    pseudo-label step, whose weighted loss runs the sensors encoder (eval
    mode) and PDDM on the triplets' sensor rows with gradient."""
    sensors = model["modality_sensors"]

    def uni_step(tri_events, mask, learning_rate: float):
        optimizer.zero_grad(set_to_none=True)
        tri = _core_triplets(model, cfg, tri_events, mask.shape[0])
        loss1 = triplet_loss_masked(tri[:, 0], tri[:, 1], tri[:, 2], mask,
                                    cfg.alpha)
        return {"loss": _finish(model, optimizer, cfg, loss1, learning_rate),
                "metric_loss1": loss1.detach()}

    def mm_step(tri_events, tri_sensors, mask, learning_rate: float):
        optimizer.zero_grad(set_to_none=True)
        tri_cap = mask.shape[0]
        tri = _core_triplets(model, cfg, tri_events, tri_cap)
        a, p, n = tri[:, 0], tri[:, 1], tri[:, 2]
        loss2 = triplet_loss_masked(a, p, n, mask, cfg.alpha)
        est = sensors["encoder"](tri_sensors).reshape(tri_cap, 3, -1)
        _, prob_ab = sensors["pddm"].score(est[:, 0], est[:, 1])
        _, prob_ac = sensors["pddm"].score(est[:, 0], est[:, 2])
        w_vec, _ = weighted_triplet_loss_per_triplet(
            a, p, n, prob_ab[:, 1], prob_ac[:, 1], cfg.alpha)
        w_loss = (w_vec * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        total = _finish(model, optimizer, cfg,
                        loss2 + cfg.lambda_multimodal * w_loss,
                        learning_rate)
        return {"loss": total, "metric_loss2": loss2.detach(),
                "weighted_loss": w_loss.detach()}

    return uni_step, mm_step


def _pad_flat(idx: List[int], tri_cap: int) -> Tuple[np.ndarray, np.ndarray]:
    t = min(len(idx) // 3, tri_cap)
    gather = np.zeros(3 * tri_cap, np.int64)
    gather[: 3 * t] = np.asarray(idx[: 3 * t], np.int64)
    mask = np.zeros(tri_cap, np.float32)
    mask[:t] = 1.0
    return gather, mask


def sensors_similarity(model: nn.Module,
                       eve_sensors: torch.Tensor) -> torch.Tensor:
    """The sensors branch's all-pairs PDDM similarity [N, N]."""
    sensors = model["modality_sensors"]
    with torch.no_grad():
        emb = sensors["encoder"](eve_sensors)
        return score_all_pairs_sym(sensors["pddm"].score, emb,
                                   block=min(128, emb.shape[0]))


def pseudo_triplets(cfg: TrainConfig, sim: np.ndarray,
                    rng: np.random.RandomState):
    """The ``--multimodal_select`` miner on a host similarity matrix."""
    if cfg.multimodal_select == "confidence":
        return select_triplets_multimodal(sim, 0.9, cfg.triplet_per_batch,
                                          rng=rng)
    if cfg.multimodal_select == "random":
        return random_triplets_multimodal(sim, cfg.triplet_per_batch,
                                          rng=rng)
    return nopos_triplets_multimodal(sim, cfg.triplet_per_batch, rng=rng)


def train(cfg: TrainConfig, event_budget: Optional[int] = None,
          result_dir: Optional[str] = None, device=None) -> TrainResult:
    """Train on ``device`` (default ``cuda``; raises when no card is
    visible and the CPU was not asked for).  ``--model_path`` restores a
    port checkpoint (weights, optimizer state and step); the JAX trainer
    has no such restore."""
    _check_supported(cfg, "multimodal_model_weak", no_cache=True)
    if cfg.multimodal_select not in SELECTORS:
        raise NotImplementedError(
            f"--multimodal_select {cfg.multimodal_select!r}; expected one "
            f"of {SELECTORS}")
    device = resolve_device(device)
    modalities = cfg.feat if isinstance(cfg.feat, list) else \
        ["resnet", "sensors"]
    if len(modalities) < 2:
        modalities = ["resnet", "sensors"]
    exp = HondaExperiment(cfg, modalities=modalities,
                          event_budget=event_budget, result_dir=result_dir,
                          limit_label_num=False)
    model = build_model(cfg, device, sensors=exp.val_extra[0].shape[-1])
    if cfg.sensors_path:
        restore_branch(model["modality_sensors"], cfg.sensors_path)
    optimizer = build_optimizer(
        cfg.optimizer, model, cfg.learning_rate,
        frozen_scopes=("modality_sensors",) if cfg.no_joint else ())
    step_host = 0
    if cfg.model_path:
        step_host = load_checkpoint(cfg.model_path, model, optimizer)

    embed_fn = make_embed_fn(model["modality_core"], cfg.normalized)
    tri_cap = 2 * cfg.triplet_per_batch
    uni_step, mm_step = make_weak_steps(model, optimizer, cfg)
    val_x = torch.from_numpy(exp.val_feats).to(device)

    def rows(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(device)

    metrics = {}
    # config-seeded host-miner streams: the JAX trainer's draws
    mine_rng = random.Random(cfg.seed)
    mul_rng = np.random.RandomState(cfg.seed)
    stream = device_prefetch(loader_batches(exp), device,
                             device_keys=("events", "events2"))
    try:
        epoch = epoch_of_step(step_host, exp.batch_per_epoch)
        while epoch < cfg.max_epochs:
            lr = learning_rate_schedule(epoch, cfg.learning_rate,
                                        cfg.static_epochs, cfg.max_epochs)
            steps_this_epoch = 0
            for batch in itertools.islice(stream, exp.batch_per_epoch):
                n = int(batch["num_events"])
                labels = batch["labels"][:n]
                lab_idx_map = np.where(np.asarray(
                    [s in exp.labeled_sessions
                     for s in batch["sessions"][:n]], bool))[0]
                events, aux = batch["events"], None
                if lab_idx_map.size:
                    emb = embed_in_chunks(
                        embed_fn, events.index_select(0, rows(lab_idx_map)),
                        device)
                    idx, _ = select_triplets_facenet(
                        labels[lab_idx_map],
                        cdist_rows(emb, emb, cfg.metric).cpu().numpy(),
                        cfg.triplet_per_batch, cfg.alpha, cfg.num_negative,
                        rng=mine_rng)
                    if idx:
                        gather, mask = _pad_flat(
                            lab_idx_map[np.asarray(idx, np.int64)].tolist(),
                            tri_cap)
                        aux = uni_step(events.index_select(0, rows(gather)),
                                       torch.from_numpy(mask).to(device), lr)
                        step_host += 1
                if epoch >= cfg.multimodal_epochs:
                    sim = sensors_similarity(
                        model, batch["events2"])[:n, :n].cpu().numpy()
                    np.fill_diagonal(sim, np.nan)
                    mul_idx, count = pseudo_triplets(cfg, sim, mul_rng)
                    if count:
                        gather, mask = _pad_flat(mul_idx, tri_cap)
                        aux = mm_step(
                            events.index_select(0, rows(gather)),
                            batch["events2"].index_select(0, rows(gather)),
                            torch.from_numpy(mask).to(device), lr)
                        step_host += 1
                if aux is not None:
                    steps_this_epoch += 1
                    loss = float(aux["loss"])
                    exp.log(step_host, {"loss": loss, "learning_rate": lr},
                            f"[{cfg.name}] epoch {epoch + 1} step "
                            f"{step_host} loss {loss:.4f}")
                if exp.control.stop_requested(step_host):
                    break
            if exp.preempted(step_host, model, optimizer):
                break
            if steps_this_epoch == 0:
                # no labeled session and the pseudo-labels not active yet:
                # the step count cannot move
                print(f"[{cfg.name}] epoch {epoch + 1}: no trainable slice "
                      "this epoch; stopping")
                break
            metrics, _ = validate(embed_fn, val_x, exp.val_labels, device,
                                  beat=exp.control.beat_fn)
            exp.log(step_host, metrics,
                    f"[{cfg.name}] epoch {epoch + 1} val mAP "
                    f"{metrics['val_mAP']:.4f}")
            exp.save(model, optimizer, step_host)
            epoch = epoch_of_step(step_host, exp.batch_per_epoch)
    finally:
        stream.close()  # cancels the feed and loader threads
        exp.close()
    return TrainResult(model, optimizer, step_host, metrics, exp.result_dir)


def main(argv=None):
    """The trainer CLI: the JAX trainer's flags, plus ``--device`` (default
    ``cuda``)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default=None)
    args, rest = p.parse_known_args(argv)
    train(TrainConfig.parse(rest), device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
