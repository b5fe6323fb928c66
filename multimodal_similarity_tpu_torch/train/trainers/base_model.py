"""Unimodal semi-hard triplet trainer (FaceNet-style), the reference's
baseline (``scripts/train_base_model.sh``).

Session batches of a fixed event budget from the session loader, and one
of three miners (``--triplet_select``):

* ``facenet``: the fused step (train/steps.py): an eval-mode embedding of
  the whole budget, semi-hard mining on the device, a train-mode
  re-forward of the mined triplets alone;
* ``facenet_host``: the reference's host semi-hard miner on exact
  differences of the current embeddings, then the gathered-triplet step;
* ``random``: the reference's random-negative miner, then the
  gathered-triplet step.

The budget batch is cast or quantized (--bf16_features / --int8_features)
and uploaded on the feed thread, two batches ahead (data/device_feed.py);
so are the ``random`` miner's triplets, which need labels only.  The
``facenet_host`` miner reads the embeddings of the parameters the last
step wrote, so it runs between steps on the main thread; under
--bf16_features it embeds the f32 rows, uploaded beside the bf16 ones, as
the JAX trainer embeds its f32 host batch.  Per-epoch
leave-one-out validation (no validation loss, as in the JAX trainer), the
embedding-projector files and a checkpoint.  No CUDA kernel of ``csrc/``
is on this path.

On more than one process (``facenet`` only, as in JAX) the step is the
data-parallel one (parallel/data_parallel.py): under ``torchrun`` every
rank draws the global budget batch and embeds its rows of it; with
``--multihost`` (and the coordinator flags, or torchrun's environment)
each rank loads its session shard (``host_local_sessions``) into its slice
of the budget, for the global lockstep batch count.  Process 0 writes the
checkpoints and the projector files (ROADMAP D6).

With --device_cache (``facenet`` only, as in JAX) the train windows stay on
the device as int8 (data/device_cache.py) and a step is one plan upload and
one fused gather + mine + train (train/cached_steps.py); --steps_per_dispatch
K runs K such steps back to back.  On more than one process the cache is
sharded over the ranks (under --multihost planned from the full session
list with the global budget) and each rank gathers its own row block.

With --model_parallel N (``facenet`` only, as in JAX) the ranks form a
data x model mesh (parallel/tensor_parallel.py): the encoder's wide
weights and their Adam moments are column-sharded over each model group,
and its data axis takes the place of the processes above (at a data axis
of one, every rank runs the single-device fused step on the whole batch).

Run:  python -m multimodal_similarity_tpu_torch.train.trainers.base_model --DATA_ROOT <dir> --triplet_select facenet ...
(``--device cpu`` runs on the CPU; the default is ``cuda``.)
"""

from __future__ import annotations

import argparse
import random
import sys
from typing import Optional

import numpy as np
import torch

from multimodal_similarity_tpu_torch import resolve_device
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.data.device_feed import feature_keys
from multimodal_similarity_tpu_torch.models import build_encoder
from multimodal_similarity_tpu_torch.ops.distances import cdist_rows
from multimodal_similarity_tpu_torch.ops.mining import (
    select_triplets_facenet, select_triplets_random)
from multimodal_similarity_tpu_torch.parallel.data_parallel import (
    make_dp_triplet_step)
from multimodal_similarity_tpu_torch.parallel.mesh import replicate
from multimodal_similarity_tpu_torch.parallel.multihost import env_world_size
from multimodal_similarity_tpu_torch.train.cached_steps import (
    make_cached_triplet_step)
from multimodal_similarity_tpu_torch.train.checkpoints import load_checkpoint
from multimodal_similarity_tpu_torch.train.state import (
    build_optimizer, learning_rate_schedule)
from multimodal_similarity_tpu_torch.train.steps import (
    embed_in_chunks, make_embed_fn, make_gathered_triplet_step,
    make_triplet_train_step)
from multimodal_similarity_tpu_torch.train.trainer import (
    epoch_of_step, validate)
from multimodal_similarity_tpu_torch.train.trainers._honda import (
    HondaExperiment)
from multimodal_similarity_tpu_torch.train.trainers.base_model_batchhard \
    import TrainResult, _check_supported, process_mesh, shard_for_tp
from multimodal_similarity_tpu_torch.utils.logging import (
    write_projector_config, write_projector_embedding)

MINERS = ("facenet", "facenet_host", "random")


def pack_triplets(idx, triplet_per_batch: int):
    """A host miner's flat [a, p, n, ...] list as fixed-size [a; p; n]
    indices [3T] and a mask [T] (padding rows index event 0, masked)."""
    t = triplet_per_batch
    tri = np.zeros(3 * t, np.int64)
    tri_mask = np.zeros(t, np.float32)
    m = min(len(idx) // 3, t)
    arr = np.asarray(idx[: 3 * m], np.int64).reshape(-1, 3)
    tri[:m], tri[t:t + m], tri[2 * t:2 * t + m] = arr.T
    tri_mask[:m] = 1.0
    return tri, tri_mask


def budget_batches(exp: HondaExperiment, cfg: TrainConfig,
                   mine_rng: random.Random, mesh=None):
    """One item per loader batch, across epochs, for the feed thread: the
    budget batch (with the random miner's triplets), or None when the
    random miner finds none.  Under --bf16_features the host miner's f32
    rows go up beside the bf16 ones as ``mine_events``: the JAX trainer
    embeds the f32 host batch for that miner.  On a ``mesh`` without
    --multihost every rank draws the global batch and keeps its rows of
    the events (labels and mask stay global); under --multihost the
    loader's batch is this rank's rows already."""
    while True:
        produced = 0
        for b in exp.loader_epoch():
            produced += 1
            if mesh is not None and not cfg.multihost:
                b["events"] = b["events"][mesh.rows(len(b["events"]))]
            if cfg.triplet_select == "random":
                n = int(b["num_events"])
                idx = select_triplets_random(
                    b["labels"][:n], cfg.triplet_per_batch,
                    cfg.num_negative, rng=mine_rng)
                if not idx:
                    yield None
                    continue
                b["tri"], b["tri_mask"] = pack_triplets(
                    idx, cfg.triplet_per_batch)
            elif cfg.triplet_select == "facenet_host" and cfg.bf16_features:
                b["mine_events"] = b["events"]
            yield b
        if not produced:
            return


def make_step_runner(cfg: TrainConfig, model, optimizer, device,
                     mine_gen: torch.Generator, mine_rng: random.Random,
                     mesh=None):
    """(the feed's device keys, ``run(batch, lr)``): one training step on
    a received batch with the configured miner (on a ``mesh``, the
    data-parallel fused step).  ``run`` returns the step's aux, or None
    when the host miner finds no triplet."""
    t_cap = cfg.triplet_per_batch
    if mesh is not None:
        dp = make_dp_triplet_step(
            model, optimizer, mesh, triplet_per_batch=t_cap,
            alpha=cfg.alpha, num_negative=cfg.num_negative,
            metric=cfg.metric, normalized=cfg.normalized,
            lambda_l2=cfg.lambda_l2, gather_smalls=cfg.multihost,
            generator=mine_gen)
        return (("events", "labels", "mask"),
                lambda batch, lr: dp(batch["events"], batch["labels"],
                                     batch["mask"], lr))
    if cfg.triplet_select == "facenet":
        fused = make_triplet_train_step(
            model, optimizer, triplet_per_batch=t_cap, alpha=cfg.alpha,
            num_negative=cfg.num_negative, metric=cfg.metric,
            normalized=cfg.normalized, lambda_l2=cfg.lambda_l2,
            generator=mine_gen)
        return (("events", "labels", "mask"),
                lambda batch, lr: fused(batch["events"], batch["labels"],
                                        batch["mask"], lr))
    step_fn = make_gathered_triplet_step(
        model, optimizer, alpha=cfg.alpha, normalized=cfg.normalized,
        lambda_l2=cfg.lambda_l2)
    if cfg.triplet_select == "random":
        return (("events", "tri", "tri_mask"),
                lambda batch, lr: step_fn(batch["events"], batch["tri"],
                                          batch["tri_mask"], lr))
    embed_fn = make_embed_fn(model, cfg.normalized)

    def mine_and_step(batch, lr):
        """The reference's semi-hard miner on the current parameters'
        embeddings of the f32 rows, exact differences in row chunks on the
        device, then the gathered-triplet step."""
        n = int(batch["num_events"])
        rows = batch.get("mine_events", batch["events"])[:n]
        emb = embed_in_chunks(embed_fn, rows, device)
        dists = cdist_rows(emb, emb, cfg.metric).cpu().numpy()
        idx, _ = select_triplets_facenet(
            batch["labels"][:n], dists, t_cap, cfg.alpha, cfg.num_negative,
            rng=mine_rng)
        if not idx:
            return None
        tri, tri_mask = (torch.from_numpy(a).to(device)
                         for a in pack_triplets(idx, t_cap))
        return step_fn(batch["events"], tri, tri_mask, lr)

    return ("events", "mine_events"), mine_and_step


def train(cfg: TrainConfig, event_budget: Optional[int] = None,
          result_dir: Optional[str] = None, device=None) -> TrainResult:
    """Train on ``device`` (default ``cuda``; raises when no card is
    visible and the CPU was not asked for)."""
    if cfg.triplet_select not in MINERS:
        raise NotImplementedError(
            f"--triplet_select {cfg.triplet_select!r}; expected one of "
            f"{MINERS}")
    _check_supported(cfg, "base_model", data_parallel=True, multihost=True,
                     tensor_parallel=True)
    if cfg.int8_features and cfg.triplet_select != "facenet":
        raise ValueError("--int8_features requires the device-fed path "
                         "(--triplet_select facenet); the host miners "
                         "gather dense features")
    if cfg.device_cache and cfg.triplet_select != "facenet":
        raise ValueError("--device_cache requires --triplet_select facenet "
                         "(the device-fed fused step)")
    device = resolve_device(device)
    event_budget = event_budget or cfg.event_per_batch
    mesh = tp = None
    if cfg.triplet_select == "facenet":
        # the budget rounded up to a multiple of the processes (of the
        # data axis under --model_parallel)
        mesh, event_budget, device, tp = process_mesh(cfg, event_budget,
                                                      device)
    elif cfg.model_parallel > 1:
        raise ValueError("--model_parallel requires --triplet_select "
                         "facenet (the jitted device step)")
    elif cfg.multihost or env_world_size() > 1:
        raise NotImplementedError(
            "--multihost requires --triplet_select facenet (the fused "
            "device-mining step; host miners are single-process)")
    if cfg.multihost and mesh is None and tp is None:
        raise RuntimeError("--multihost needs >= 2 devices across processes")
    # the data row and the data axis (the processes without a model axis)
    row, rows = (mesh.rank, mesh.size) if mesh is not None else (0, 1)
    # --multihost: this rank loads its data row's session shard and its
    # slice of the budget, with the reference's per-process loader seed
    exp = HondaExperiment(
        cfg, event_budget=(event_budget // rows if cfg.multihost
                           else event_budget),
        result_dir=result_dir, supports_int8=True, mesh=mesh, tp=tp,
        session_shard=cfg.multihost,
        loader_seed=cfg.seed + row if cfg.multihost else None)
    init_gen = torch.Generator().manual_seed(cfg.seed)
    drop_gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    mine_gen = torch.Generator(device=device).manual_seed(cfg.seed + 2)
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
            print(f"[{cfg.name}] tensor-parallel: {len(sharded)} weight "
                  f"tensors column-sharded over {cfg.model_parallel} chips")
            print(f"[{cfg.name}] data-parallel over {rows} devices x "
                  f"{cfg.model_parallel} model-parallel"
                  + (f" on {rows} hosts" if cfg.multihost else ""))
    elif mesh is not None:
        replicate([p.data for p in model.parameters()], mesh)
        if not cfg.silent_mode:
            print(f"[{cfg.name}] data-parallel over {mesh.size} processes"
                  + (" (multihost)" if cfg.multihost else ""))

    embed_fn = make_embed_fn(model, cfg.normalized)
    val_x = torch.from_numpy(exp.val_feats).to(device)
    # a config-seeded stream for the host miners: the JAX trainer's draws
    mine_rng = random.Random(cfg.seed)
    device_keys, run = make_step_runner(cfg, model, optimizer, device,
                                        mine_gen, mine_rng, mesh)

    # --device_cache: the train windows stay on the device; a step is one
    # plan upload and one fused gather + mine + train (None: stream)
    cache = exp.build_cache(device, mesh=mesh)
    cached = None if cache is None else (cache, make_cached_triplet_step(
        model, optimizer, cache, triplet_per_batch=cfg.triplet_per_batch,
        alpha=cfg.alpha, num_negative=cfg.num_negative, metric=cfg.metric,
        normalized=cfg.normalized, lambda_l2=cfg.lambda_l2,
        gather_generator=torch.Generator(device=device).manual_seed(
            cfg.seed + 3),
        mine_generator=mine_gen))

    def echo(e, s, sc):
        return (f"[{cfg.name}] epoch {e + 1} step {s} loss {sc['loss']:.4f} "
                f"triplets {sc['triplet_num']:.0f}")

    metrics = {}
    exp.open_feed(device, budget_batches(exp, cfg, mine_rng, mesh),
                  device_keys, cached=cached, **feature_keys(cfg))
    try:
        epoch = epoch_of_step(step_host, exp.batch_per_epoch)
        while epoch < cfg.max_epochs:
            lr = learning_rate_schedule(epoch, cfg.learning_rate,
                                        cfg.static_epochs, cfg.max_epochs)
            step_at_epoch_start = step_host
            # a None batch has no random triplet, a None step no host-mined
            # one
            step_host = exp.run_epoch(run, lr, step_host, epoch, echo)
            if exp.preempted(step_host, model, optimizer):
                break
            if step_host == step_at_epoch_start:
                print(f"[{cfg.name}] epoch {epoch + 1}: no trainable batch; "
                      "stopping")
                break
            metrics, val_emb = validate(embed_fn, val_x, exp.val_labels,
                                        device, beat=exp.control.beat_fn)
            exp.log(step_host, metrics,
                    f"[{cfg.name}] epoch {epoch + 1} val mAP "
                    f"{metrics['val_mAP']:.4f} R@1 "
                    f"{metrics['val_recall@1']:.4f}")
            if exp.is_chief:
                write_projector_embedding(exp.result_dir,
                                          val_emb.cpu().numpy())
                write_projector_config(exp.result_dir)
            exp.save(model, optimizer, step_host)
            epoch = epoch_of_step(step_host, exp.batch_per_epoch)
    finally:
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
