"""CUB-200 feature-level triplet retrieval trainer (the reference's
``base_model_CUB``, ``scripts/train_base_CUB.sh``).

A ``CUBLayer`` projection over precomputed 1024-d features, trained by the
fused semi-hard step (train/steps.py ``make_triplet_train_step``) on
class-balanced batches of ``max(batch_size, 64)`` rows (sampled classes,
5-10 images each).  CUB has no background class, so the train labels go to
the miner as label + 1 with an all-ones mask.  Every ``max_epochs // 5``
steps (and after the last) the test split is embedded and scored by
leave-one-out mAP and recall@1/2/4/8, and a checkpoint is written.  No
CUDA kernel of ``csrc/`` is on this path.

Run:  python -m multimodal_similarity_tpu_torch.train.trainers.base_model_CUB --DATA_ROOT <dir with feat_train.npy ...> --emb_dim 64 ...
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
from multimodal_similarity_tpu_torch.data.cub import (
    load_cub, sample_cub_batch)
from multimodal_similarity_tpu_torch.models import CUBLayer
from multimodal_similarity_tpu_torch.train.state import (
    build_optimizer, learning_rate_schedule)
from multimodal_similarity_tpu_torch.train.steps import (
    make_embed_fn, make_triplet_train_step)
from multimodal_similarity_tpu_torch.train.trainers._cub import (
    CUBRun, class_index)
from multimodal_similarity_tpu_torch.train.trainers.base_model_batchhard \
    import TrainResult

RECALLS = (1, 2, 4, 8)


def train(cfg: TrainConfig, data: Optional[dict] = None,
          result_dir: Optional[str] = None, device=None) -> TrainResult:
    """``data`` (the ``load_cub`` arrays) overrides loading from
    ``cfg.DATA_ROOT``.  Trains on ``device`` (default ``cuda``; raises when
    no card is visible and the CPU was not asked for)."""
    device = resolve_device(device)
    run = CUBRun(cfg, result_dir)
    if data is None:
        data = load_cub(cfg.DATA_ROOT)
    feat_train = np.asarray(data["feat_train"], np.float32)
    label_train = np.asarray(data["label_train"]).reshape(-1)
    val_x = torch.from_numpy(np.asarray(data["feat_test"], np.float32)).to(
        device)
    val_labels = np.asarray(data["label_test"]).reshape(-1)
    class_idx = class_index(label_train)

    model = CUBLayer(
        feat_train.shape[1], cfg.emb_dim, cfg.keep_prob,
        generator=torch.Generator().manual_seed(cfg.seed),
        dropout_generator=torch.Generator(device=device).manual_seed(
            cfg.seed + 1)).to(device)
    optimizer = build_optimizer(cfg.optimizer, model, cfg.learning_rate)
    start = run.first_epoch(model, optimizer)
    step_fn = make_triplet_train_step(
        model, optimizer, triplet_per_batch=cfg.triplet_per_batch,
        alpha=cfg.alpha, num_negative=cfg.num_negative, metric=cfg.metric,
        normalized=cfg.normalized, lambda_l2=cfg.lambda_l2,
        generator=torch.Generator(device=device).manual_seed(cfg.seed + 2))
    embed_fn = make_embed_fn(model, cfg.normalized)

    rng_np = np.random.RandomState(cfg.seed)
    batch = max(cfg.batch_size, 64)
    metrics, step = {}, start
    try:
        for epoch in range(start, cfg.max_epochs):
            lr = learning_rate_schedule(epoch, cfg.learning_rate,
                                        cfg.static_epochs, cfg.max_epochs)
            idx = sample_cub_batch(class_idx, batch, rng_np)
            events = torch.from_numpy(feat_train[idx]).to(device)
            # CUB has no background class: every label anchors
            labels = torch.from_numpy(label_train[idx] + 1).to(device)
            mask = torch.ones(len(idx), device=device)
            aux = step_fn(events, labels, mask, lr)
            step += 1
            scalars = {k: float(v) for k, v in aux.items()}
            scalars["learning_rate"] = lr
            run.logger.log(step, scalars)
            if not cfg.silent_mode and (epoch + 1) % 50 == 0:
                print(f"[{cfg.name}] step {step} loss {scalars['loss']:.4f} "
                      f"triplets {scalars['triplet_num']:.0f}")
            if run.validates(epoch, cfg.max_epochs):
                metrics, _ = run.validate(step, embed_fn, val_x, val_labels,
                                          device, RECALLS)
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
