"""PDDM on CUB attribute vectors (the reference's ``pddm_CUB``,
``scripts/CUB_pddm.sh``).

An ``OutputLayer`` projects the 312-d attributes to ``emb_dim``
(parameter group ``encoder``) and a PDDM head (group ``pddm``) scores
pairs.  Each step mines semi-hard triplets on the eval-mode, detached
embeddings of the batch (``masked_self_distance`` with an all-ones mask,
then ``mine_semihard_triplets``), re-embeds the triplets in train mode,
and minimises the PDDM margin loss (a hinge at 0.6 on prob[:, 0] of the
anchor-positive against the anchor-negative pair) plus 0.5 x the masked
triplet loss.  Validation and checkpoints as in ``base_model_CUB``.  No
CUDA kernel of ``csrc/`` is on this path.

Run:  python -m multimodal_similarity_tpu_torch.train.trainers.pddm_CUB --DATA_ROOT <dir with att_train.npy ...> --emb_dim 64 ...
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
from multimodal_similarity_tpu_torch.data.cub import (
    load_cub, sample_cub_batch)
from multimodal_similarity_tpu_torch.models import PDDM, OutputLayer
from multimodal_similarity_tpu_torch.ops.losses import triplet_loss_masked
from multimodal_similarity_tpu_torch.ops.mining import mine_semihard_triplets
from multimodal_similarity_tpu_torch.train.state import (
    apply_gradients, build_optimizer, l2_regularization,
    learning_rate_schedule)
from multimodal_similarity_tpu_torch.train.steps import (
    l2_normalize, make_embed_fn, masked_self_distance)
from multimodal_similarity_tpu_torch.train.trainers._cub import (
    CUBRun, class_index)
from multimodal_similarity_tpu_torch.train.trainers.base_model_batchhard \
    import TrainResult

PDDM_MARGIN = 0.6


class PDDMModel(nn.Module):
    """The trainer's two parameter groups, named as the JAX params."""

    def __init__(self, n_input: int, cfg: TrainConfig,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = OutputLayer(n_input, cfg.emb_dim, cfg.keep_prob,
                                   generator, dropout_generator)
        self.pddm = PDDM(cfg.emb_dim, generator)


def pddm_update(model: nn.Module, optimizer, cfg: TrainConfig,
                rows: torch.Tensor, mined, learning_rate: float) -> dict:
    """Train-mode forward of the mined [a; p; n] ``rows`` through
    ``model.encoder``, the PDDM margin loss (a hinge at 0.6 on prob[:, 0]
    of the anchor-positive against the anchor-negative pair) plus 0.5 x the
    masked triplet loss (+ L2), and one optimizer step.  Returns the step's
    device scalars."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    emb = model.encoder(rows)
    if cfg.normalized:
        emb = l2_normalize(emb)
    t = mined.anchor.shape[0]
    a, p, n = emb[:t], emb[t:2 * t], emb[2 * t:]
    metric_loss = triplet_loss_masked(a, p, n, mined.mask, cfg.alpha)
    _, prob_ap = model.pddm.score(a, p)
    _, prob_an = model.pddm.score(a, n)
    hinge = torch.clamp(prob_ap[:, 0] - prob_an[:, 0] + PDDM_MARGIN,
                        min=0.0)
    pddm_loss = (hinge * mined.mask).sum() / torch.clamp(
        mined.mask.sum(), min=1.0)
    total = pddm_loss + 0.5 * metric_loss
    if cfg.lambda_l2:
        total = total + cfg.lambda_l2 * l2_regularization(model)
    total.backward()
    apply_gradients(optimizer, learning_rate)
    return {"loss": total.detach(), "pddm_loss": pddm_loss.detach(),
            "metric_loss": metric_loss.detach(),
            "triplet_num": mined.mask.sum()}


def make_pddm_step(model: PDDMModel, optimizer, cfg: TrainConfig,
                   generator: Optional[torch.Generator]) -> Callable:
    """step(atts [B, n_input], labels [B], learning_rate) -> device
    scalars; ``generator`` (on the device) drives the mining draws."""
    embed = make_embed_fn(model.encoder, cfg.normalized)

    def step(atts: torch.Tensor, labels: torch.Tensor, learning_rate: float):
        mask = torch.ones(atts.shape[0], device=atts.device)
        dists = masked_self_distance(embed(atts), mask, cfg.metric)
        mined = mine_semihard_triplets(
            dists, labels, generator, cfg.triplet_per_batch,
            alpha=cfg.alpha, num_negative=cfg.num_negative)
        tri_idx = torch.cat([mined.anchor, mined.positive, mined.negative])
        return pddm_update(model, optimizer, cfg, atts[tri_idx], mined,
                           learning_rate)

    return step


def train(cfg: TrainConfig, data: Optional[dict] = None,
          result_dir: Optional[str] = None, device=None) -> TrainResult:
    """``data`` (the ``load_cub(..., attributes=True)`` arrays) overrides
    loading from ``cfg.DATA_ROOT``.  Trains on ``device`` (default
    ``cuda``; raises when no card is visible and the CPU was not asked
    for)."""
    device = resolve_device(device)
    run = CUBRun(cfg, result_dir)
    if data is None:
        data = load_cub(cfg.DATA_ROOT, attributes=True)
    att_train = np.asarray(data["att_train"], np.float32)
    label_train = np.asarray(data["label_train"]).reshape(-1)
    val_x = torch.from_numpy(np.asarray(data["att_test"], np.float32)).to(
        device)
    val_labels = np.asarray(data["label_test"]).reshape(-1)
    class_idx = class_index(label_train)

    model = PDDMModel(
        att_train.shape[1], cfg,
        generator=torch.Generator().manual_seed(cfg.seed),
        dropout_generator=torch.Generator(device=device).manual_seed(
            cfg.seed + 1)).to(device)
    optimizer = build_optimizer(cfg.optimizer, model, cfg.learning_rate)
    start = run.first_epoch(model, optimizer)
    step_fn = make_pddm_step(
        model, optimizer, cfg,
        torch.Generator(device=device).manual_seed(cfg.seed + 2))
    embed_fn = make_embed_fn(model.encoder, cfg.normalized)

    rng_np = np.random.RandomState(cfg.seed)
    batch = max(cfg.batch_size, 64)
    metrics, step = {}, start
    try:
        for epoch in range(start, cfg.max_epochs):
            lr = learning_rate_schedule(epoch, cfg.learning_rate,
                                        cfg.static_epochs, cfg.max_epochs)
            idx = sample_cub_batch(class_idx, batch, rng_np)
            aux = step_fn(torch.from_numpy(att_train[idx]).to(device),
                          torch.from_numpy(label_train[idx] + 1).to(device),
                          lr)
            step += 1
            run.logger.log(step, {k: float(v) for k, v in aux.items()})
            if run.validates(epoch, cfg.max_epochs):
                metrics, _ = run.validate(step, embed_fn, val_x, val_labels,
                                          device)
                run.ckpt.save(model, optimizer, step)
    finally:
        run.close()
    return TrainResult(model, optimizer, step, metrics, run.result_dir)


def main(argv=None):
    """The trainer CLI: the JAX trainer's flags, plus ``--device`` (default
    ``cuda``)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default=None)
    args, rest = p.parse_known_args(argv)
    train(TrainConfig.parse(rest), device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
