"""Semi-hard triplet trainer on the event TFRecord pipeline, with true
sequence lengths.

Events stream from the one-SequenceExample-per-event files that
``generate_event_tfrecords`` writes under ``<DATA_ROOT>/tfrecords2/``
(``EventTFRecordLoader``: the native threaded parse, zero-padded to
``--MAX_LENGTH_FRAMES`` frames, 64 events a batch), and ``ConvLSTM``
embeds each whole frame sequence at its last real frame.  A step embeds
the batch without gradient, mines semi-hard triplets on the device
(``masked_self_distance`` and the semi-hard miner, padding rows masked),
gathers the 3T mined events on the device, embeds them again with
gradient and takes the masked triplet loss.  Each epoch validates on the
validation sessions' records (leave-one-out retrieval mAP and Recall@1)
and saves a checkpoint.

The batch goes up on the feed thread (data/device_feed.py).  Single
process: ``--multihost`` and a multi-process ``torchrun`` launch raise
(ROADMAP D6), ``--device_cache`` too (D5).  SIGTERM checkpoints the exact
step and exits; ``--watchdog_secs`` and ``--profile_dir`` run as on the
other trainers.  No CUDA kernel of ``csrc/`` is on this path.

Run:  python -m multimodal_similarity_tpu_torch.train.trainers.base_model_tf --DATA_ROOT <dir> --network convlstm --feat resnet ...
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
from multimodal_similarity_tpu_torch.data.device_feed import device_prefetch
from multimodal_similarity_tpu_torch.data.tfrecord_loader import (
    EventTFRecordLoader, list_event_tfrecords)
from multimodal_similarity_tpu_torch.eval.metrics import retrieval_metrics
from multimodal_similarity_tpu_torch.models import ConvLSTM
from multimodal_similarity_tpu_torch.ops.losses import triplet_loss_masked
from multimodal_similarity_tpu_torch.ops.mining import mine_semihard_triplets
from multimodal_similarity_tpu_torch.train.checkpoints import (
    CheckpointManager, load_checkpoint)
from multimodal_similarity_tpu_torch.train.run_control import RunControl
from multimodal_similarity_tpu_torch.train.state import (
    apply_gradients, build_optimizer, l2_regularization,
    learning_rate_schedule)
from multimodal_similarity_tpu_torch.train.steps import (
    l2_normalize, masked_self_distance)
from multimodal_similarity_tpu_torch.train.trainer import (
    epoch_of_step, setup_experiment)
from multimodal_similarity_tpu_torch.train.trainers.base_model_batchhard \
    import TrainResult, _check_supported
from multimodal_similarity_tpu_torch.utils.logging import MetricsLogger

FEED_KEYS = ("features", "seq_len", "labels", "mask")


def frame_layout(cfg: TrainConfig):
    """(feature name, flat frame width, (n_h, n_w, channels)) of
    ``--feat``: a flat feature is a 1 x 1 map."""
    feat = cfg.feat if isinstance(cfg.feat, str) else cfg.feat[0]
    spatial = cfg.feat_dim.get(feat)
    flat_dim = int(np.prod(spatial or (cfg.n_input,)))
    hwc = (tuple(spatial) if spatial and len(spatial) == 3
           else (1, 1, flat_dim))
    return feat, flat_dim, hwc


def build_model(cfg: TrainConfig, hwc, device: torch.device) -> ConvLSTM:
    """ConvLSTM over ``--MAX_LENGTH_FRAMES`` frames, weights from
    ``cfg.seed``."""
    n_h, n_w, n_c = hwc
    return ConvLSTM(max_time=cfg.MAX_LENGTH_FRAMES, n_C=cfg.n_C,
                    emb_dim=cfg.emb_dim, n_input=n_c, n_h=n_h, n_w=n_w,
                    generator=torch.Generator().manual_seed(cfg.seed)
                    ).to(device)


def make_step(model, optimizer, cfg: TrainConfig, hwc,
              generator: Optional[torch.Generator]):
    """step(batch, learning_rate) -> device scalars: the no-grad
    embedding of the batch, semi-hard mining on its masked distances, the
    3T mined events embedded again with gradient, the masked triplet loss
    (+ L2) and one optimizer step."""

    def embed(frames, seq_len):
        emb = model(frames, seq_len)
        return l2_normalize(emb) if cfg.normalized else emb

    def step(batch, learning_rate: float):
        frames = batch["features"].reshape(
            batch["features"].shape[:2] + tuple(hwc))
        seq_len, mask = batch["seq_len"], batch["mask"]
        model.train()
        with torch.no_grad():
            emb_mine = embed(frames, seq_len)
        mined = mine_semihard_triplets(
            masked_self_distance(emb_mine, mask, cfg.metric),
            batch["labels"], generator, cfg.triplet_per_batch,
            alpha=cfg.alpha, num_negative=cfg.num_negative, valid=mask)
        tri_idx = torch.cat([mined.anchor, mined.positive, mined.negative])
        optimizer.zero_grad(set_to_none=True)
        emb = embed(frames.index_select(0, tri_idx),
                    seq_len.index_select(0, tri_idx))
        t = mined.mask.shape[0]
        loss = triplet_loss_masked(emb[:t], emb[t:2 * t], emb[2 * t:],
                                   mined.mask, cfg.alpha)
        total = loss
        if cfg.lambda_l2:
            total = total + cfg.lambda_l2 * l2_regularization(model)
        total.backward()
        apply_gradients(optimizer, learning_rate)
        return {"loss": total.detach(), "triplet_num": mined.mask.sum(),
                "active_count": mined.active_count}

    return step


def embed_records(model, cfg: TrainConfig, paths, feat: str,
                  flat_dim: int, hwc, event_per_batch: int,
                  device: torch.device):
    """The eval-mode embeddings (l2-normalised under ``--normalized``) of
    every record in ``paths``, in order, and their labels."""
    loader = EventTFRecordLoader(paths, feat, flat_dim, event_per_batch,
                                 cfg.MAX_LENGTH_FRAMES, shuffle=False)
    embs, labs = [], []
    model.eval()
    with torch.no_grad():
        for vb in loader.epoch():
            n = int(vb["num_events"])
            frames = torch.from_numpy(vb["features"][:n]).to(device)
            emb = model(frames.reshape((n, cfg.MAX_LENGTH_FRAMES) + hwc),
                        torch.from_numpy(vb["seq_len"][:n]).to(device))
            embs.append(l2_normalize(emb) if cfg.normalized else emb)
            labs.append(vb["labels"][:n])
    return torch.cat(embs), np.concatenate(labs)


def validate(model, cfg: TrainConfig, paths, feat: str, flat_dim: int, hwc,
             event_per_batch: int, device: torch.device):
    """Leave-one-out retrieval metrics of ``embed_records``."""
    m_ap, _, recalls = retrieval_metrics(*embed_records(
        model, cfg, paths, feat, flat_dim, hwc, event_per_batch, device))
    return {"val_mAP": m_ap, "val_recall@1": recalls[1]}


def train(cfg: TrainConfig, event_per_batch: int = 64,
          result_dir: Optional[str] = None, device=None) -> TrainResult:
    """Train on ``device`` (default ``cuda``; raises when no card is
    visible and the CPU was not asked for).  ``--model_path`` restores a
    port checkpoint (weights, optimizer state and step); the JAX trainer
    has no such restore."""
    _check_supported(cfg, "base_model_tf", no_cache=True)
    device = resolve_device(device)
    feat, flat_dim, hwc = frame_layout(cfg)
    train_paths = list_event_tfrecords(cfg.tfrecords_root, cfg.train_session)
    val_paths = list_event_tfrecords(cfg.tfrecords_root, cfg.val_session)
    if not train_paths:
        raise FileNotFoundError(
            f"no event tfrecords under {cfg.tfrecords_root} "
            "(run data.tfrecords.generate_event_tfrecords first)")
    result_dir = setup_experiment(cfg, result_dir=result_dir)
    logger = MetricsLogger(result_dir)
    ckpt = CheckpointManager(result_dir, cfg.name)

    loader = EventTFRecordLoader(train_paths, feat, flat_dim,
                                 event_per_batch, cfg.MAX_LENGTH_FRAMES,
                                 seed=cfg.seed)
    model = build_model(cfg, hwc, device)
    optimizer = build_optimizer(cfg.optimizer, model, cfg.learning_rate)
    step_host = 0
    if cfg.model_path:
        step_host = load_checkpoint(cfg.model_path, model, optimizer)
    mine_gen = torch.Generator(device=device).manual_seed(cfg.seed + 2)
    step = make_step(model, optimizer, cfg, hwc, mine_gen)

    metrics = {}
    # the SIGTERM guard, the --watchdog_secs hang watchdog (beaten after
    # each step's scalars are read back) and the --profile_dir step window
    control = RunControl(cfg)
    try:
        epoch = epoch_of_step(step_host, loader.batches_per_epoch)
        while epoch < cfg.max_epochs:
            lr = learning_rate_schedule(epoch, cfg.learning_rate,
                                        cfg.static_epochs, cfg.max_epochs)
            stream = device_prefetch(loader.epoch(), device, FEED_KEYS)
            try:
                for batch in stream:
                    aux = step(batch, lr)
                    step_host += 1
                    scalars = {k: float(v) for k, v in aux.items()}
                    logger.log(step_host, scalars)
                    control.step_done(step_host)  # scalars read back
                    if not cfg.silent_mode:
                        print(f"[{cfg.name}] epoch {epoch + 1} step "
                              f"{step_host} loss {scalars['loss']:.4f}")
                    if control.stop_requested(step_host):
                        break
            finally:
                stream.close()
            # checkpoint the exact step and exit; --model_path resumes
            if control.preempted(step_host,
                                 lambda s: ckpt.save(model, optimizer, s)):
                break
            if val_paths:
                metrics = validate(model, cfg, val_paths, feat, flat_dim,
                                   hwc, event_per_batch, device)
                logger.log(step_host, metrics)
            ckpt.save(model, optimizer, step_host)
            epoch = epoch_of_step(step_host, loader.batches_per_epoch)
    finally:
        control.close()
        logger.close()
    return TrainResult(model, optimizer, step_host, metrics, result_dir)


def main(argv=None):
    """The trainer CLI: the JAX trainer's flags, plus ``--device`` (default
    ``cuda``)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default=None)
    args, rest = p.parse_known_args(argv)
    train(TrainConfig.parse(rest), device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
