"""End-to-end CUB trainer: a CNN tower, ``CUBLayer`` and a batch-structured
loss on images (the reference's ``base_CUB``, ``scripts/CUB_tensorflow.sh``).

``--network inception_v2`` builds the slim InceptionV2 tower
(models/inception_v2.py), whose batch norms update their running
statistics in training mode and use them in validation; any other value
builds the compact ``ConvBackbone``.  Either way the tower is the model's
``InceptionV2`` attribute, so its parameters sit under the scope that
takes the reference's 0.1x pretrained-branch gradient scale
(train/state.py ``PRETRAINED_BRANCH_SCOPES``).  ``slim_checkpoint=``, an
.npz of slim InceptionV2 variables, grafts pretrained weights onto the
InceptionV2 tower (``models/slim_graft.py``; every parameter and running
statistic, or it raises), as the JAX trainer does; the conv backbone, as
there, ignores it.  Without it the tower starts from random weights.

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

A step is :meth:`CUBTrainer.step`, the body of ``train()``'s loop: the
draw from the run's ``RandomState``, the gather from the host f32 images,
the upload, :func:`make_cub_step`'s step (on a card, its phases replayed
from CUDA graphs: :class:`GraphedCUBStep`) and the step's log.  Spans
(``utils/profiling.py``): ``cub.step`` (unit) holds ``cub.sample`` (the
draw and the gather, host), ``cub.upload``, ``cub.crop``, ``cub.tower``
(the tower's forward), ``cub.loss`` (``CUBLayer``, the normalisation and
the loss), ``cub.backward`` and ``cub.optimizer``; ``cub.log`` follows it
(the readback of the step's scalars).  Counters ``cub.images`` and
``cub.upload_bytes``.

Validation embeds centre crops of the test images.  ``debug=True`` runs 2
epochs (``debug_CUB``).

Run:  python -m multimodal_similarity_tpu_torch.train.trainers.base_CUB --DATA_ROOT <dir with image_train.npy ...> --network inception_v2 --loss triplet ...
(``--device cpu`` runs on the CPU, the default is ``cuda``; ``--crop``
sets the random crop's side, default 224, the reference's crop of its
256 x 256 images.)
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
from multimodal_similarity_tpu_torch.models import (
    CUBLayer, InceptionV2, graft_slim_npz)
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
from multimodal_similarity_tpu_torch.utils.logging import MetricsLogger
from multimodal_similarity_tpu_torch.utils.profiling import count, span

LOSSES = ("triplet", "lifted", "mylifted", "batchhard")
FEATURES = 1024
# the reference's random crop of its 256 x 256 images (src/base_CUB.py)
CROP = 224


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


def crop_offsets(images: torch.Tensor, crop: int,
                 generator: Optional[torch.Generator]):
    """(ox, oy): a random crop's offsets for each of the [B, H, W, C]
    images, from [0, H - crop] and [0, W - crop], both ends included (as
    ``tf.random_crop``), drawn on the images' device."""
    b, h, w, _ = images.shape
    dev = images.device
    ox = torch.randint(0, max(h - crop, 0) + 1, (b,), generator=generator,
                       device=dev)
    oy = torch.randint(0, max(w - crop, 0) + 1, (b,), generator=generator,
                       device=dev)
    return ox, oy


def crop_at(images: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor,
            crop: int) -> torch.Tensor:
    """[B, H, W, C] -> the [B, crop, crop, C] windows at offsets ``ox``,
    ``oy`` [B], scaled to [-1, 1]."""
    dev = images.device
    r = torch.arange(crop, device=dev)
    out = images[torch.arange(images.shape[0], device=dev)[:, None, None],
                 (ox[:, None] + r)[:, :, None], (oy[:, None] + r)[:, None, :]]
    return (out - 0.5) * 2.0


def random_crop(images: torch.Tensor, crop: int,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """[B, H, W, C] -> random [B, crop, crop, C] windows scaled to [-1, 1]
    (:func:`crop_offsets`, :func:`crop_at`)."""
    return crop_at(images, *crop_offsets(images, crop, generator), crop)


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
                  crop_gen: Optional[torch.Generator],
                  graphs: bool = False) -> Callable:
    """step(images [B, H, W, 3] in [0, 1], labels [B], learning_rate) ->
    device scalars: random crops, a train-mode forward (batch norms update
    their running statistics), the ``--loss`` (+ L2) and one optimizer
    step.  ``graphs=True`` (a card's) replays the step's phases from CUDA
    graphs (:class:`GraphedCUBStep`) where the head's dropout is off; with
    dropout, which draws inside the step, the step runs as written."""
    loss_fn = make_cub_loss(cfg, cfg.loss)

    def head_loss(feats: torch.Tensor, labels: torch.Tensor):
        emb = model.CUBLayer(feats)
        if cfg.normalized:
            emb = l2_normalize(emb)
        metric = loss_fn(emb, labels)
        total = metric
        if cfg.lambda_l2:
            total = total + cfg.lambda_l2 * l2_regularization(model)
        return total, metric

    def step(images: torch.Tensor, labels: torch.Tensor,
             learning_rate: float):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with span("cub.crop"):
            x = random_crop(images, crop, crop_gen)
        with span("cub.tower"):
            feats = model.InceptionV2(x)
        with span("cub.loss"):
            total, metric = head_loss(feats, labels)
        with span("cub.backward"):
            total.backward()
        with span("cub.optimizer"):
            apply_gradients(optimizer, learning_rate)
        return {"loss": total.detach(), "metric_loss": metric.detach()}

    if graphs and model.CUBLayer.dropout.rate == 0.0:
        return GraphedCUBStep(model, optimizer, crop, crop_gen, step,
                              head_loss)
    return step


class GraphedCUBStep:
    """:func:`make_cub_step`'s step with its phases replayed from CUDA
    graphs, on a stream of its own that follows the caller's.

    Issued op by op, a step of the InceptionV2 tower costs the host about
    3,700 launches, longer than the card takes to run them, so the step
    would go at the host's pace.  The first call takes the step as written
    (it settles the lazy initialisations, and Adam makes its moments);
    the second captures the crop, the tower's forward, the loss
    and the backward, four graphs of one memory pool, and that call and
    every later one copies its batch and its crop offsets (drawn as
    :func:`random_crop` draws them) into the graphs' inputs, replays them
    under the phases' spans and steps the optimizer as written.  The
    captured backward writes the gradients into the tensors it made at the
    capture, so they are never set to None after it; the batch norms'
    running statistics move inside the tower's graph."""

    def __init__(self, model: CUBNet, optimizer, crop: int,
                 crop_gen: Optional[torch.Generator], eager: Callable,
                 head_loss: Callable):
        self.model, self.optimizer = model, optimizer
        self.crop, self.crop_gen = crop, crop_gen
        self.eager, self.head_loss = eager, head_loss
        self.stream = torch.cuda.Stream()
        self.calls = 0
        self.graphs = None

    def __call__(self, images: torch.Tensor, labels: torch.Tensor,
                 learning_rate: float):
        caller = torch.cuda.current_stream()
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            out = self._step(images, labels, learning_rate)
        caller.wait_stream(self.stream)
        return out

    def _step(self, images, labels, learning_rate):
        self.calls += 1
        if self.graphs is None:
            if self.calls == 1:
                return self.eager(images, labels, learning_rate)
            self._capture(images, labels)
        with span("cub.crop"):
            ox, oy = crop_offsets(images, self.crop, self.crop_gen)
            self.ox.copy_(ox)
            self.oy.copy_(oy)
            self.x.copy_(images)
            self.y.copy_(labels)
            self.graphs[0].replay()
        for name, graph in zip(("cub.tower", "cub.loss", "cub.backward"),
                               self.graphs[1:]):
            with span(name):
                graph.replay()
        with span("cub.optimizer"):
            apply_gradients(self.optimizer, learning_rate)
        return {"loss": self.total.clone(), "metric_loss": self.metric.clone()}

    def _capture(self, images: torch.Tensor, labels: torch.Tensor) -> None:
        self.x, self.y = torch.empty_like(images), torch.empty_like(labels)
        self.ox = torch.zeros(images.shape[0], dtype=torch.long,
                              device=images.device)
        self.oy = torch.zeros_like(self.ox)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        pool = torch.cuda.graph_pool_handle()
        graphs = [torch.cuda.CUDAGraph() for _ in range(4)]

        def capture(graph):
            return torch.cuda.graph(graph, pool=pool, stream=self.stream)

        with capture(graphs[0]):
            x = crop_at(self.x, self.ox, self.oy, self.crop)
        with capture(graphs[1]):
            feats = self.model.InceptionV2(x)
        with capture(graphs[2]):
            total, metric = self.head_loss(feats, self.y)
        with capture(graphs[3]):
            total.backward()
        self.total, self.metric = total.detach(), metric.detach()
        # the crop and the features pass from one graph to the next
        self.between = (x, feats)
        self.graphs = graphs


class CUBTrainer:
    """The body of ``train()``'s step loop over a prepared run.

    ``step(learning_rate)`` draws a class-balanced batch of
    ``max(batch_size, 32)`` rows (``sample_cub_batch`` from a
    ``RandomState(seed)``), gathers it from the host f32 ``images``,
    uploads it, takes one :func:`make_cub_step` step (crops from a
    generator on ``device`` seeded with seed + 2; on a card, replayed from
    CUDA graphs, :class:`GraphedCUBStep`) and logs the step's
    scalars to ``logger``, a readback; it returns the step's device
    scalars.  ``steps`` counts the steps taken, from ``start``."""

    def __init__(self, cfg: TrainConfig, model: CUBNet, optimizer,
                 images: np.ndarray, labels: np.ndarray, crop: int,
                 device, logger: MetricsLogger, start: int = 0):
        self.images, self.labels = images, labels
        self.device, self.logger, self.steps = device, logger, start
        self.class_idx = class_index(labels)
        self.batch = max(cfg.batch_size, 32)
        self.rng = np.random.RandomState(cfg.seed)
        self.step_fn = make_cub_step(
            model, optimizer, cfg, crop,
            torch.Generator(device=device).manual_seed(cfg.seed + 2),
            graphs=torch.device(device).type == "cuda")

    def step(self, learning_rate: float) -> dict:
        with span("cub.step", unit=True):
            with span("cub.sample"):
                idx = sample_cub_batch(self.class_idx, self.batch, self.rng)
                x, y = self.images[idx], self.labels[idx]
            count("cub.images", len(idx))
            count("cub.upload_bytes", x.nbytes + y.nbytes)
            with span("cub.upload"):
                x = torch.from_numpy(x).to(self.device)
                y = torch.from_numpy(y).to(self.device)
            aux = self.step_fn(x, y, learning_rate)
        self.steps += 1
        with span("cub.log"):
            self.logger.log(self.steps, {k: float(v) for k, v in aux.items()})
        return aux


def train(cfg: TrainConfig, data: Optional[dict] = None, crop: int = 56,
          debug: bool = False, slim_checkpoint: Optional[str] = None,
          result_dir: Optional[str] = None, device=None) -> TrainResult:
    """``data`` holds image_train [N, H, W, 3] in [0, 1], label_train,
    image_test and label_test (else the .npy files of ``cfg.DATA_ROOT``).
    Trains on ``device`` (default ``cuda``; raises when no card is visible
    and the CPU was not asked for).  ``crop`` defaults to the JAX
    trainer's 56; the CLI's ``--crop`` to the reference's 224."""
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

    model = build_model(cfg, device)
    if cfg.network == "inception_v2" and slim_checkpoint:
        graft_slim_npz(model.InceptionV2, slim_checkpoint)
    optimizer = build_optimizer(cfg.optimizer, model, cfg.learning_rate)
    start = run.first_epoch(model, optimizer)
    trainer = CUBTrainer(cfg, model, optimizer, images, labels, crop,
                         device, run.logger, start)
    embed = make_embed_fn(model, cfg.normalized)

    def embed_fn(x: torch.Tensor) -> torch.Tensor:
        return embed(center_crop(x, crop))

    max_epochs = 2 if debug else cfg.max_epochs
    metrics = {}
    try:
        for epoch in range(start, max_epochs):
            trainer.step(learning_rate_schedule(
                epoch, cfg.learning_rate, cfg.static_epochs, max_epochs))
            if run.validates(epoch, max_epochs):
                metrics, _ = run.validate(trainer.steps, embed_fn,
                                          val_images, val_labels, device)
                run.ckpt.save(model, optimizer, trainer.steps)
    finally:
        run.close()
    return TrainResult(model, optimizer, trainer.steps, metrics,
                       run.result_dir)


def parse_cli(argv=None):
    """The trainer CLI's own flags, ``--device`` (default ``cuda``) and
    ``--crop`` (default :data:`CROP`), and the :class:`TrainConfig` of the
    JAX trainer's flags."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default=None)
    p.add_argument("--crop", type=int, default=CROP)
    args, rest = p.parse_known_args(argv)
    return args, TrainConfig.parse(rest)


def main(argv=None):
    """The trainer CLI: the JAX trainer's flags, plus ``--device`` and
    ``--crop`` (:func:`parse_cli`)."""
    args, cfg = parse_cli(argv)
    train(cfg, crop=args.crop, device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
