"""Triplet + verification multitask trainer
(``scripts/train_multitask_model.sh``).

The fused semi-hard step of ``base_model`` on the budget's masked
self-distances (``masked_self_distance``, then ``mine_semihard_triplets``),
whose mined triplets drive both the triplet loss and a ``PairSim2``
verification head with dropout: (anchor, positive) pairs labelled 1,
(anchor, negative) pairs 0, a masked cross-entropy weighted by
``--lambda_ver``.  The feed, validation and checkpoint are
``pddm_model``'s (parameter groups ``encoder`` and ``ver``), and so is
--device_cache.  No CUDA kernel of ``csrc/`` is on this path.

Run:  python -m multimodal_similarity_tpu_torch.train.trainers.multitask_model --DATA_ROOT <dir> --network convrtsn --lambda_ver 0.1 ...
(``--device cpu`` runs on the CPU; the default is ``cuda``.)
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Optional

import torch
from torch import nn

from multimodal_similarity_tpu_torch import resolve_device
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.data.device_feed import (
    dequant_features, take_features)
from multimodal_similarity_tpu_torch.models import PairSim2
from multimodal_similarity_tpu_torch.ops.losses import triplet_loss_masked
from multimodal_similarity_tpu_torch.ops.mining import mine_semihard_triplets
from multimodal_similarity_tpu_torch.train.checkpoints import load_checkpoint
from multimodal_similarity_tpu_torch.train.state import (
    apply_gradients, build_optimizer, l2_regularization)
from multimodal_similarity_tpu_torch.train.steps import (
    l2_normalize, make_embed_fn, masked_self_distance)
from multimodal_similarity_tpu_torch.train.trainers._honda import (
    HondaExperiment)
from multimodal_similarity_tpu_torch.train.trainers._loop import (
    cache_feed, retrieval_validation, run_budget_trainer)
from multimodal_similarity_tpu_torch.train.trainers.base_model_batchhard \
    import TrainResult, _check_supported
from multimodal_similarity_tpu_torch.train.trainers.pddm_model import (
    pair_model)


def verification_loss(logits: torch.Tensor, labels: torch.Tensor,
                      mask: torch.Tensor):
    """(mean cross-entropy, accuracy) of 2-way ``logits`` against int
    ``labels`` over the pairs where ``mask`` is 1."""
    nll = -torch.log_softmax(logits, dim=-1).gather(
        1, labels[:, None].long())[:, 0]
    denom = torch.clamp(mask.sum(), min=1.0)
    acc = ((logits.argmax(dim=-1) == labels).float() * mask).sum() / denom
    return (nll * mask).sum() / denom, acc


def make_multitask_step(model: nn.Module, optimizer, cfg: TrainConfig,
                        generator: Optional[torch.Generator]) -> Callable:
    """step(events, labels, mask, learning_rate) -> device scalars;
    ``events`` dense or the int8 cache's {"q", "scale"}; ``generator`` (on
    the device) drives the mining draws."""
    embed = make_embed_fn(model.encoder, cfg.normalized)

    def step(events, labels: torch.Tensor, mask: torch.Tensor,
             learning_rate: float):
        dists = masked_self_distance(embed(dequant_features(events)), mask,
                                     cfg.metric)
        mined = mine_semihard_triplets(
            dists, labels, generator, cfg.triplet_per_batch,
            alpha=cfg.alpha, num_negative=cfg.num_negative, valid=mask)
        tri_idx = torch.cat([mined.anchor, mined.positive, mined.negative])

        model.train()
        optimizer.zero_grad(set_to_none=True)
        emb = model.encoder(dequant_features(take_features(events,
                                                           tri_idx)))
        if cfg.normalized:
            emb = l2_normalize(emb)
        t = mined.anchor.shape[0]
        a, p, n = emb[:t], emb[t:2 * t], emb[2 * t:]
        metric_loss = triplet_loss_masked(a, p, n, mined.mask, cfg.alpha)
        # verification on the same triplets: (a, p) -> 1, (a, n) -> 0
        logits, _ = model.ver.score(torch.cat([a, a]), torch.cat([p, n]))
        pair_lab = torch.cat([torch.ones(t, dtype=torch.int64,
                                         device=emb.device),
                              torch.zeros(t, dtype=torch.int64,
                                          device=emb.device)])
        ver_loss, ver_acc = verification_loss(
            logits, pair_lab, torch.cat([mined.mask, mined.mask]))
        total = metric_loss + cfg.lambda_ver * ver_loss
        if cfg.lambda_l2:
            total = total + cfg.lambda_l2 * l2_regularization(model)
        total.backward()
        apply_gradients(optimizer, learning_rate)
        return {"loss": total.detach(), "metric_loss": metric_loss.detach(),
                "ver_loss": ver_loss.detach(), "ver_acc": ver_acc,
                "active_count": mined.active_count,
                "triplet_num": mined.mask.sum()}

    return step


def train(cfg: TrainConfig, event_budget: Optional[int] = None,
          result_dir: Optional[str] = None, device=None) -> TrainResult:
    """Train on ``device`` (default ``cuda``; raises when no card is
    visible and the CPU was not asked for).  ``--model_path`` restores a
    port checkpoint (weights, optimizer state and step)."""
    _check_supported(cfg, "multitask_model")
    device = resolve_device(device)
    exp = HondaExperiment(cfg, event_budget=event_budget,
                          result_dir=result_dir)
    model = pair_model(cfg, "ver", lambda gen, drop: PairSim2(
        cfg.emb_dim, cfg.keep_prob, gen, drop), device)
    optimizer = build_optimizer(cfg.optimizer, model, cfg.learning_rate)
    step_host = 0
    if cfg.model_path:
        step_host = load_checkpoint(cfg.model_path, model, optimizer)
    step = make_multitask_step(
        model, optimizer, cfg,
        torch.Generator(device=device).manual_seed(cfg.seed + 2))
    return run_budget_trainer(
        cfg, exp, model, optimizer,
        lambda b, epoch, lr: step(b["events"], b["labels"], b["mask"], lr),
        device, step_host,
        retrieval_validation(model.encoder, cfg, exp, device),
        echo_keys=("ver_acc",),
        cached=cache_feed(exp, cfg, lambda ev, lab, m, lr: step(
            ev[0], lab, m, lr), device))


def main(argv=None):
    """The trainer CLI: the JAX trainer's flags, plus ``--device`` (default
    ``cuda``)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default=None)
    args, rest = p.parse_known_args(argv)
    train(TrainConfig.parse(rest), device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
