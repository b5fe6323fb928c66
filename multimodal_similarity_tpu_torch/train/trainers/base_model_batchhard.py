"""Batch-hard trainer on class-balanced batches.

Round-robin class-balanced batches from the session loader, the encoder,
l2-normalisation, and a batch-structured objective through fused CUDA
kernels: batch-hard ("In Defense of the Triplet Loss",
ops/kernels/batch_hard.py) or, with ``loss_kind="lifted"``, the
lifted-structured loss (ops/kernels/lifted.py; base_model_lifted.py).  Adam
(eps=0.1), per-epoch leave-one-out validation and a checkpoint.  Under
``torchrun`` with more than one process, every rank draws the same global
balanced batch and trains on its contiguous rows of it; the loss rides the
f32 ring (parallel/ring_mining.py, parallel/ring_lifted.py) and the ranks'
gradients are summed (ROADMAP D6); process 0 writes the checkpoints.
--multihost raises (the JAX trainer has no multi-process path; D6).
With --device_cache on more than one process, the cache is sharded over
the ranks (data/device_cache.py): each rank gathers its own row block and
the balanced rows reach their ranks in one all-to-all.  Streamed, the
balanced selection, its row gather, the --bf16_features cast or
--int8_features quantizing and the upload run on the feed thread, two
batches ahead (data/device_feed.py).  With --device_cache the train
windows stay on the device as int8 (data/device_cache.py): the balanced
selection runs on each plan's host labels, and one fused step gathers the
selected rows' TSN frames and trains (``make_cached_balanced_step``);
--steps_per_dispatch K issues K such steps back to back
(train/cached_steps.py).  Run control (``--profile_dir``,
``--watchdog_secs``, SIGTERM checkpoint-and-stop) is the experiment's
(_honda.py).

With --model_parallel N (a process group of N or a multiple of N ranks,
N dividing each host's ranks) the ranks form a data x model mesh
(parallel/tensor_parallel.py): the encoder's wide weights and their Adam
moments are column-sharded over each model group of N consecutive ranks,
and the data axis takes the place of the processes above.  At a data axis
of one the loss runs the fused kernels on the whole batch on every rank,
as one process does; at two or more it rides the ring over the data axis.

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
from multimodal_similarity_tpu_torch.parallel.data_parallel import (
    backward_once, sum_gradients)
from multimodal_similarity_tpu_torch.parallel.mesh import (
    auto_mesh, replicate)
from multimodal_similarity_tpu_torch.parallel.multihost import (
    backend_for, env_world_size, initialize_distributed)
from multimodal_similarity_tpu_torch.parallel.ring_lifted import (
    make_ring_lifted_loss)
from multimodal_similarity_tpu_torch.parallel.ring_mining import (
    make_ring_batch_hard_loss)
from multimodal_similarity_tpu_torch.parallel.tensor_parallel import (
    auto_mesh_tp, shard_module_tp, tp_sharded_leaves)
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


def _check_supported(cfg: TrainConfig, trainer: str, no_cache: bool = False,
                     data_parallel: bool = False, multihost: bool = False,
                     tensor_parallel: bool = False) -> None:
    """Raise for every option ``trainer`` cannot take.  ``no_cache``: the
    JAX trainer has no cached feed either (and streams there silently), so
    --device_cache raises ValueError (ROADMAP D5).  A trainer without a
    multi-process path in JAX (which ignores --multihost there) raises
    ValueError for --multihost unless ``multihost``, and for a
    ``torchrun`` launch of more than one process unless ``data_parallel``
    (ROADMAP D6).  One without a tensor-parallel path in JAX (which
    ignores --model_parallel there) raises ValueError for it unless
    ``tensor_parallel`` (ROADMAP D8)."""
    if no_cache and cfg.device_cache:
        raise ValueError(f"--device_cache: {trainer} has no cached feed")
    if cfg.model_parallel > 1 and not tensor_parallel:
        raise ValueError(
            f"--model_parallel: {trainer} has no tensor-parallel path")
    if cfg.multihost and not multihost:
        raise ValueError(f"--multihost: {trainer} has no multi-process path")
    if env_world_size() > 1 and not (data_parallel or multihost):
        raise ValueError(f"{trainer} has no multi-process path "
                         f"(WORLD_SIZE={env_world_size()})")


def process_mesh(cfg: TrainConfig, batch_axis: int, device: torch.device):
    """(mesh | None, batch axis rounded to the mesh, device, tp | None):
    the process group started from the ``--multihost`` coordinator flags,
    or else from ``torchrun``'s environment, on the backend ``device``
    takes (NCCL on the card); None without one, or with a single process.
    On a mesh the device returned is the rank's own (``cuda:<LOCAL_RANK>``
    under NCCL): the trainer places everything there, the feed thread
    included, whose current CUDA device is not the one the main thread was
    bound to.  With --model_parallel N, ``tp`` is the data x model mesh
    (``auto_mesh_tp``: JAX's checks and rounding to the data axis) and
    ``mesh`` its data mesh, None at a data axis of one."""
    if cfg.multihost:
        initialize_distributed(
            cfg.coordinator_address or None, cfg.num_processes or None,
            cfg.process_id if cfg.process_id >= 0 else None,
            backend=backend_for(device))
    else:
        initialize_distributed(backend=backend_for(device))
    tp = None
    if cfg.model_parallel > 1:
        tp, batch_axis = auto_mesh_tp(batch_axis, cfg.model_parallel,
                                      verbose=not cfg.silent_mode)
        mesh, world = (tp.data if tp.data.size > 1 else None), tp.world
    else:
        mesh, batch_axis = auto_mesh(batch_axis,
                                     verbose=not cfg.silent_mode)
        world = mesh
    if world is not None and world.device.type != device.type:
        raise ValueError(f"the process group's backend runs on "
                         f"{world.device.type}; the trainer's device is "
                         f"{device}")
    return mesh, batch_axis, (device if world is None else world.device), tp


def shard_for_tp(cfg: TrainConfig, model, optimizer, tp, detail: str = ""
                 ) -> list:
    """Column-shard ``model`` and ``optimizer``'s state over ``tp``'s
    model groups (``shard_module_tp``, after ``replicate``); raises JAX's
    ValueError when no parameter splits (``detail`` closes its first
    clause).  Returns the split leaves."""
    mp = cfg.model_parallel
    if not tp_sharded_leaves(model, mp):
        raise ValueError(
            f"--model_parallel {mp}: no parameter has a trailing dim "
            f"divisible by {mp}{detail}; tensor parallelism would be a "
            "silent no-op")
    return shard_module_tp(model, tp, optimizer)


def make_loss(cfg: TrainConfig, loss_kind: str,
              precision: Optional[str] = None, mesh=None) -> Callable:
    """loss(emb, labels) -> the loss tuple of the trainer's objective.

    Batch-hard: the soft margin unless ``--no_soft`` (then ``alpha``), bf16
    stats.  Lifted: margin ``alpha``, f32 stats (the JAX default for
    lifted), and the triangular bounded forward when the embeddings are
    l2-normalised.  ``precision`` overrides the kind's default.  On a
    ``mesh`` of processes ``emb`` and ``labels`` are this rank's rows and
    the loss rides the f32 ring (parallel/ring_mining.py,
    parallel/ring_lifted.py), as the JAX trainer's does on a mesh."""
    if loss_kind not in ("batchhard", "lifted"):
        raise ValueError(f"unknown loss_kind {loss_kind!r}; expected "
                         "'batchhard' or 'lifted'")
    if mesh is not None:
        if loss_kind == "batchhard":
            return make_ring_batch_hard_loss(
                mesh, cfg.alpha if cfg.no_soft else "soft")
        return make_ring_lifted_loss(mesh, cfg.alpha)
    if loss_kind == "batchhard":
        margin = cfg.alpha if cfg.no_soft else "soft"
        prec = precision or "bf16"
        return lambda emb, labels: batch_hard_fused(
            emb, labels, margin, weighted=True, precision=prec)
    prec = precision or "f32"
    return lambda emb, labels: lifted_loss_fused(
        emb, labels, cfg.alpha, weighted=True, precision=prec,
        bounded=cfg.normalized)


def make_balanced_batch_step(model, optimizer, cfg: TrainConfig,
                             loss_kind: str = "batchhard",
                             precision: Optional[str] = None, mesh=None):
    """step(events [B, ...], labels [B], learning_rate) -> device scalars,
    one optimizer step of the ``loss_kind`` objective over a class-balanced
    batch; ``events`` dense or the int8 feed's {"q", "scale"}.  On a
    ``mesh`` the step takes this rank's rows of the batch, the loss rides
    the ring, and the ranks' gradients are summed before Adam steps (the
    gradient of the one global loss, as in JAX)."""
    loss_fn = make_loss(cfg, loss_kind, precision, mesh)

    def step(events, labels: torch.Tensor, learning_rate: float):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        emb = model(dequant_features(events))
        if cfg.normalized:
            emb = l2_normalize(emb)
        loss, num_active, *_ = loss_fn(emb, labels)
        total = loss
        if mesh is None:
            if cfg.lambda_l2:
                total = total + cfg.lambda_l2 * l2_regularization(model)
            total.backward()
        else:
            reg = (cfg.lambda_l2 * l2_regularization(model)
                   if cfg.lambda_l2 else None)
            backward_once(loss, reg, mesh)
            sum_gradients(model, mesh)
            if reg is not None:
                total = total + reg
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
    ``make_balanced_batch_step``.  Over a cache on a process mesh each
    rank gathers its row block, receives its contiguous share of the
    selected rows in one all-to-all, and trains on the ring."""
    inner = make_balanced_batch_step(model, optimizer, cfg, loss_kind,
                                     mesh=cache.mesh)
    cut = cache.plan_rows

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
                     sel_rng: random.Random, mesh=None):
    """One item per loader batch, across epochs, for the feed thread (so
    the draws stay in loader order): the batch with its balanced [B]
    selection as ``rows`` (on a ``mesh``, this rank's contiguous rows of
    it), or None when it has no foreground class."""
    while True:
        produced = 0
        for b in exp.loader_epoch():
            produced += 1
            n = int(b["num_events"])
            idx = select_batch_balanced(b["labels"][:n], batch_size,
                                        rng=sel_rng)
            if idx.size and mesh is not None:
                idx = idx[mesh.rows(idx.size)]
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
    _check_supported(cfg, f"base_model_{loss_kind}", data_parallel=True,
                     tensor_parallel=True)
    device = resolve_device(device)
    # under torchrun: every rank draws the same global balanced batch and
    # trains on its rows of it (ROADMAP D6); under --model_parallel the
    # rows are its data row's
    batch_size = cfg.batch_size if cfg.batch_size > 8 else 64
    mesh, batch_size, device, tp = process_mesh(cfg, batch_size, device)
    exp = HondaExperiment(cfg, event_budget=event_budget,
                          result_dir=result_dir, supports_int8=True,
                          mesh=mesh, tp=tp)
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
    if tp is not None:
        replicate([p.data for p in model.parameters()], tp.world)
        sharded = shard_for_tp(cfg, model, optimizer, tp,
                               f" (emb_dim {cfg.emb_dim})")
        if not cfg.silent_mode:
            print(f"[{cfg.name}] {loss_kind}: {len(sharded)} weight "
                  f"tensors column-sharded over {cfg.model_parallel} "
                  f"chips x {tp.data.size}-way data parallel")
    elif mesh is not None:
        replicate([p.data for p in model.parameters()], mesh)
    if mesh is not None and not cfg.silent_mode:
        print(f"[{cfg.name}] {loss_kind} data-parallel over "
              f"{mesh.size} processes (ring)")

    embed_fn = make_embed_fn(model, cfg.normalized)
    step_fn = make_balanced_batch_step(model, optimizer, cfg, loss_kind,
                                       mesh=mesh)
    # the validation features go to the device once, not every epoch
    val_x = torch.from_numpy(exp.val_feats).to(device)
    # a config-seeded rng for the balanced selection: the same draws as the
    # JAX trainer's
    sel_rng = random.Random(cfg.seed)

    # --device_cache: the train windows stay on the device; a step is one
    # plan upload and one fused gather + train (None: stream)
    cache = exp.build_cache(device, mesh=mesh)
    cached = None if cache is None else (cache, make_cached_balanced_step(
        model, optimizer, cfg, cache,
        torch.Generator(device=device).manual_seed(cfg.seed + 3), loss_kind))

    def echo(e, s, sc):
        return f"[{cfg.name}] epoch {e + 1} step {s} loss {sc['loss']:.4f}"

    def run(batch, lr):
        return step_fn(batch["events"], batch["labels"], lr)

    metrics = {}
    exp.open_feed(device, balanced_batches(exp, batch_size, sel_rng, mesh),
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
            if exp.preempted(step_host, model, optimizer):
                break
            if step_host == step_at_epoch_start:
                print(f"[{cfg.name}] epoch {epoch + 1}: no trainable batch; "
                      "stopping")
                break
            metrics, _ = validate(embed_fn, val_x, exp.val_labels, device,
                                  val_loss_fn, beat=exp.control.beat_fn)
            exp.log(step_host, metrics,
                    f"[{cfg.name}] epoch {epoch + 1} val mAP "
                    f"{metrics['val_mAP']:.4f}")
            exp.save(model, optimizer, step_host)
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
