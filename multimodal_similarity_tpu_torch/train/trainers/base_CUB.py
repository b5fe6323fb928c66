"""End-to-end CUB trainer: a CNN tower, ``CUBLayer`` and a batch-structured
loss on images (the reference's ``base_CUB``, ``scripts/CUB_tensorflow.sh``).

``--network inception_v2`` builds the slim InceptionV2 tower
(models/inception_v2.py), whose batch norms update their running
statistics in training mode and use them in validation; any other value
builds the compact ``ConvBackbone``.  Either way the tower is the model's
``InceptionV2`` attribute, so its parameters sit under the scope that
takes the reference's 0.1x pretrained-branch gradient scale
(train/state.py ``PRETRAINED_BRANCH_SCOPES``).  Pretrained slim weights
are not ported (``slim_checkpoint=`` raises; ROADMAP slice 9): the tower
starts from random weights.

Each step takes a class-balanced batch of ``max(batch_size, 32)`` images,
random ``crop`` x ``crop`` crops (offsets from [0, h - crop] inclusive,
drawn from an explicit ``torch.Generator``) scaled to [-1, 1], and one of
``--loss``:

* ``triplet``: ``triplet_semihard_loss``;
* ``lifted`` / ``mylifted``: the dense ``lifted_loss`` over euclidean /
  squared-euclidean distances, unweighted;
* ``batchhard``: ``batch_hard_fused(emb, labels, "soft",
  weighted=False)``, the fused batch-hard stats (bf16, ``algo="auto"``):
  the batch-hard kernel on CUDA.

Validation embeds centre crops of the test images.  ``debug=True`` runs 2
epochs (``debug_CUB``).

Run:  python -m multimodal_similarity_tpu_torch.train.trainers.base_CUB --DATA_ROOT <dir with image_train.npy ...> --network inception_v2 --loss triplet ...
(``--device cpu`` runs on the CPU; the default is ``cuda``.)
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from multimodal_similarity_tpu_torch import resolve_device
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.data.cub import sample_cub_batch
from multimodal_similarity_tpu_torch.models import CUBLayer, InceptionV2
from multimodal_similarity_tpu_torch.models.inception_v2 import (
    Conv, lecun_normal_)
from multimodal_similarity_tpu_torch.ops.distances import pairwise_distance
from multimodal_similarity_tpu_torch.ops.kernels.batch_hard import (
    batch_hard_fused)
from multimodal_similarity_tpu_torch.ops.losses import (
    lifted_loss, triplet_semihard_loss)
from multimodal_similarity_tpu_torch.train.state import (
    apply_gradients, build_optimizer, l2_regularization,
    learning_rate_schedule)
from multimodal_similarity_tpu_torch.train.steps import (
    l2_normalize, make_embed_fn)
from multimodal_similarity_tpu_torch.train.trainers._cub import (
    CUBRun, class_index)
from multimodal_similarity_tpu_torch.train.trainers.base_model_batchhard \
    import TrainResult

LOSSES = ("triplet", "lifted", "mylifted", "batchhard")
FEATURES = 1024


class ConvBackbone(nn.Module):
    """Compact stand-in for the InceptionV2 trunk: ``stages`` stride-2 3x3
    convs (with bias, TF ``SAME`` padding) and relus, a global average
    pool and a Dense projection to ``features``; NHWC input."""

    def __init__(self, features: int = FEATURES, stages: int = 3,
                 in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        ch, cin = 32, in_channels
        for s in range(stages):
            self.add_module(f"conv{s}", Conv(cin, ch, 3, 2, bias=True,
                                             generator=generator))
            cin, ch = ch, ch * 2
        self.stages = stages
        self.proj = nn.Linear(cin, features)
        lecun_normal_(self.proj.weight, cin, generator)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(self.proj.weight.dtype).permute(0, 3, 1, 2).contiguous()
        for s in range(self.stages):
            h = torch.relu(getattr(self, f"conv{s}")(h))
        return self.proj(h.mean(dim=(2, 3)))


class CUBNet(nn.Module):
    """Tower then head, under the JAX param scopes ``InceptionV2`` and
    ``CUBLayer``."""

    def __init__(self, tower: nn.Module, head: CUBLayer):
        super().__init__()
        self.InceptionV2 = tower
        self.CUBLayer = head

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.CUBLayer(self.InceptionV2(x))


def build_model(cfg: TrainConfig, device) -> CUBNet:
    gen = torch.Generator().manual_seed(cfg.seed)
    tower = (InceptionV2(generator=gen) if cfg.network == "inception_v2"
             else ConvBackbone(generator=gen))
    head = CUBLayer(FEATURES, cfg.emb_dim, cfg.keep_prob, generator=gen,
                    dropout_generator=torch.Generator(
                        device=device).manual_seed(cfg.seed + 1))
    return CUBNet(tower, head).to(device)


def random_crop(images: torch.Tensor, crop: int,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """[B, H, W, C] -> random [B, crop, crop, C] windows scaled to [-1, 1]:
    offsets from [0, H - crop] and [0, W - crop], both ends included (as
    ``tf.random_crop``), drawn on the images' device."""
    b, h, w, _ = images.shape
    dev = images.device
    ox = torch.randint(0, max(h - crop, 0) + 1, (b,), generator=generator,
                       device=dev)
    oy = torch.randint(0, max(w - crop, 0) + 1, (b,), generator=generator,
                       device=dev)
    r = torch.arange(crop, device=dev)
    out = images[torch.arange(b, device=dev)[:, None, None],
                 (ox[:, None] + r)[:, :, None], (oy[:, None] + r)[:, None, :]]
    return (out - 0.5) * 2.0


def center_crop(images: torch.Tensor, crop: int) -> torch.Tensor:
    """The centre ``crop`` x ``crop`` window (offset (H - crop) // 2 on
    both axes), scaled to [-1, 1]."""
    off = (images.shape[1] - crop) // 2
    return (images[:, off:off + crop, off:off + crop] - 0.5) * 2.0


def make_cub_loss(cfg: TrainConfig, loss_kind: str) -> Callable:
    """loss(emb, labels) -> the scalar metric loss of ``--loss``."""
    if loss_kind == "triplet":
        return lambda emb, labels: triplet_semihard_loss(labels, emb,
                                                         cfg.alpha)
    if loss_kind in ("lifted", "mylifted"):
        metric = "euclidean" if loss_kind == "lifted" else "squaredeuclidean"
        return lambda emb, labels: lifted_loss(
            pairwise_distance(emb, emb, metric), labels, cfg.alpha,
            weighted=False)[0]
    if loss_kind == "batchhard":
        return lambda emb, labels: batch_hard_fused(
            emb, labels, "soft", weighted=False)[0]
    raise NotImplementedError(f"--loss {loss_kind!r}; expected one of "
                              f"{LOSSES}")


def make_cub_step(model: CUBNet, optimizer, cfg: TrainConfig, crop: int,
                  crop_gen: Optional[torch.Generator]) -> Callable:
    """step(images [B, H, W, 3] in [0, 1], labels [B], learning_rate) ->
    device scalars: random crops, a train-mode forward (batch norms update
    their running statistics), the ``--loss`` (+ L2) and one optimizer
    step."""
    loss_fn = make_cub_loss(cfg, cfg.loss)

    def step(images: torch.Tensor, labels: torch.Tensor,
             learning_rate: float):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        emb = model(random_crop(images, crop, crop_gen))
        if cfg.normalized:
            emb = l2_normalize(emb)
        metric = loss_fn(emb, labels)
        total = metric
        if cfg.lambda_l2:
            total = total + cfg.lambda_l2 * l2_regularization(model)
        total.backward()
        apply_gradients(optimizer, learning_rate)
        return {"loss": total.detach(), "metric_loss": metric.detach()}

    return step


def train(cfg: TrainConfig, data: Optional[dict] = None, crop: int = 56,
          debug: bool = False, slim_checkpoint: Optional[str] = None,
          result_dir: Optional[str] = None, device=None) -> TrainResult:
    """``data`` holds image_train [N, H, W, 3] in [0, 1], label_train,
    image_test and label_test (else the .npy files of ``cfg.DATA_ROOT``).
    Trains on ``device`` (default ``cuda``; raises when no card is visible
    and the CPU was not asked for)."""
    if slim_checkpoint:
        raise NotImplementedError(
            "slim_checkpoint: grafting pretrained slim weights is not "
            "ported yet (ROADMAP slice 9)")
    make_cub_loss(cfg, cfg.loss)           # an unknown --loss raises here
    device = resolve_device(device)
    run = CUBRun(cfg, result_dir)
    if data is None:
        data = {k: np.load(os.path.join(cfg.DATA_ROOT, f"{k}.npy"))
                for k in ("image_train", "label_train", "image_test",
                          "label_test")}
    images = np.asarray(data["image_train"], np.float32)
    labels = np.asarray(data["label_train"]).reshape(-1)
    val_images = np.asarray(data["image_test"], np.float32)
    val_labels = np.asarray(data["label_test"]).reshape(-1)
    class_idx = class_index(labels)

    model = build_model(cfg, device)
    optimizer = build_optimizer(cfg.optimizer, model, cfg.learning_rate)
    start = run.first_epoch(model, optimizer)
    step_fn = make_cub_step(
        model, optimizer, cfg, crop,
        torch.Generator(device=device).manual_seed(cfg.seed + 2))
    embed = make_embed_fn(model, cfg.normalized)

    def embed_fn(x: torch.Tensor) -> torch.Tensor:
        return embed(center_crop(x, crop))

    rng_np = np.random.RandomState(cfg.seed)
    batch = max(cfg.batch_size, 32)
    max_epochs = 2 if debug else cfg.max_epochs
    metrics, step = {}, start
    try:
        for epoch in range(start, max_epochs):
            lr = learning_rate_schedule(epoch, cfg.learning_rate,
                                        cfg.static_epochs, max_epochs)
            idx = sample_cub_batch(class_idx, batch, rng_np)
            aux = step_fn(torch.from_numpy(images[idx]).to(device),
                          torch.from_numpy(labels[idx]).to(device), lr)
            step += 1
            run.logger.log(step, {k: float(v) for k, v in aux.items()})
            if run.validates(epoch, max_epochs):
                metrics, _ = run.validate(step, embed_fn, val_images,
                                          val_labels, device)
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
