"""PairSim pretraining on k-means pseudo-labels with a negative-ratio
curriculum (``scripts/unimodal_pretrain.sh``, ``MODE=pairsim``), the last
link of the pretrain chain.

Reads the ``train_data.pkl`` and ``val_data.pkl`` that
``unimodal_pretrain_cluster`` writes (beside ``--model_path`` by default)
and trims every cluster to the smallest one's size.  Each epoch walks
``enumerate_batch``: blocks of ``num_pos`` rows of every cluster give all
same-cluster ordered pairs plus ``phase`` times as many random negatives,
``phase`` growing from 0.5 with the epoch; the ``PairSim`` score of each
pair takes a 2-way NLL.  Validation pairs the first row of each cluster
with the others and as many random negatives (``prepare_val``); the
epoch's metrics are the last step's loss and accuracy and the validation
accuracy, and it saves a checkpoint.  The pair draws come from one
``np.random.RandomState(--seed)``, as in the JAX trainer, so both see the
same pairs.  The embeddings live on the device and each step gathers its
pairs there.  No CUDA kernel of ``csrc/`` is on this path.

Run:  python -m multimodal_similarity_tpu_torch.train.trainers.unimodal_pretrain_pairsim --DATA_ROOT <dir> --emb_dim 128 --model_path <kmeans dir>/x ...
(``--device cpu`` runs on the CPU; the default is ``cuda``.)
"""

from __future__ import annotations

import argparse
import itertools
import os
import pickle
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from multimodal_similarity_tpu_torch import resolve_device
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.models import PairSim
from multimodal_similarity_tpu_torch.train.checkpoints import CheckpointManager
from multimodal_similarity_tpu_torch.train.state import (
    apply_gradients, build_optimizer, learning_rate_schedule)
from multimodal_similarity_tpu_torch.train.trainer import setup_experiment
from multimodal_similarity_tpu_torch.train.trainers.base_model_batchhard \
    import TrainResult
from multimodal_similarity_tpu_torch.utils.logging import MetricsLogger

NUM_POS = 5


def enumerate_batch(labels: np.ndarray, num_pos: int, phase: float,
                    rng=None):
    """Curriculum pair batches: per block of ``num_pos`` rows of every
    cluster, all ordered same-cluster pairs plus ``phase`` times as many
    negatives (a row of the block against the same row of another
    cluster).  Rows must be grouped by cluster, clusters of equal size."""
    rng = rng or np.random
    labels = np.asarray(labels).reshape(-1)
    label_num = int(np.max(labels)) + 1
    all_idx = np.transpose(
        np.arange(len(labels)).reshape(-1, len(labels) // label_num))

    for start, end in zip(range(0, all_idx.shape[0], num_pos),
                          range(num_pos, all_idx.shape[0] + num_pos,
                                num_pos)):
        end = min(end, all_idx.shape[0])
        perm = list(itertools.permutations(range(start, end), 2))
        a_idx: List[int] = []
        b_idx: List[int] = []
        for i in range(label_num):
            for p in perm:
                a_idx.append(all_idx[p[0], i])
                b_idx.append(all_idx[p[1], i])
            neg_num = int(phase * len(perm))
            neg_label = [l for l in range(label_num) if l != i]
            for _ in range(neg_num):
                temp = rng.randint(start, end)
                a_idx.append(all_idx[temp, i])
                b_idx.append(all_idx[
                    temp, neg_label[rng.randint(len(neg_label))]])
        yield a_idx, b_idx


def prepare_val(labels: np.ndarray,
                rng=None) -> Tuple[List[int], List[int]]:
    """Validation pairs: each cluster's first row against its other rows,
    then as many random rows of other clusters."""
    rng = rng or np.random
    labels = np.asarray(labels).reshape(-1)
    a_idx: List[int] = []
    b_idx: List[int] = []
    for lab in sorted(set(labels.tolist())):
        idx = np.where(labels == lab)[0]
        count = 0
        for p in itertools.permutations(idx, 2):
            if p[0] != idx[0]:
                break
            a_idx.append(p[0])
            b_idx.append(p[1])
            count += 1
        neg_idx = np.where(labels != lab)[0]
        for _ in range(count):
            a_idx.append(idx[0])
            b_idx.append(int(neg_idx[rng.randint(len(neg_idx))]))
    return a_idx, b_idx


def pair_labels(labels, a_idx, b_idx) -> np.ndarray:
    labels = np.asarray(labels).reshape(-1)
    return (labels[np.asarray(a_idx, np.int64)]
            == labels[np.asarray(b_idx, np.int64)]).astype(np.int64)


def load_clusters(train_data_path: str):
    """(feats, labels) of ``train_data.pkl``, every cluster cut to the
    smallest one's size and the rows grouped by cluster (enumerate_batch
    needs equal clusters), and (val feats, val labels) of the
    ``val_data.pkl`` beside it (the training rows when there is none)."""
    with open(train_data_path, "rb") as f:
        data = pickle.load(f)
    feats = np.asarray(data["feats"], np.float32)
    labels = np.asarray(data["labels"]).reshape(-1)
    counts = np.bincount(labels)
    m = int(counts[counts > 0].min())
    keep = np.concatenate([np.where(labels == lab)[0][:m]
                           for lab in np.unique(labels)])
    keep = keep[np.argsort(labels[keep], kind="stable")]
    feats, labels = feats[keep], labels[keep]

    val_path = os.path.join(os.path.dirname(train_data_path), "val_data.pkl")
    if not os.path.exists(val_path):
        return (feats, labels), (feats, labels)
    with open(val_path, "rb") as f:
        vdata = pickle.load(f)
    return (feats, labels), (np.asarray(vdata["feats"], np.float32),
                             np.asarray(vdata["labels"]).reshape(-1))


def build_head(cfg: TrainConfig, n_input: int,
               device: torch.device) -> PairSim:
    """The PairSim head, weights from ``cfg.seed``, dropout masks from
    ``cfg.seed + 1``."""
    return PairSim(
        n_input, keep_prob=cfg.keep_prob,
        generator=torch.Generator().manual_seed(cfg.seed),
        dropout_generator=torch.Generator(device=device).manual_seed(
            cfg.seed + 1)).to(device)


def train(cfg: TrainConfig, train_data_path: Optional[str] = None,
          result_dir: Optional[str] = None, device=None) -> TrainResult:
    """Train on ``device`` (default ``cuda``; raises when no card is
    visible and the CPU was not asked for).  ``train_data_path`` defaults
    to ``dirname(--model_path)/train_data.pkl``."""
    device = resolve_device(device)
    train_data_path = train_data_path or os.path.join(
        os.path.dirname(cfg.model_path or ""), "train_data.pkl")
    (feats, labels), (val_feats, val_labels) = load_clusters(
        train_data_path)

    result_dir = setup_experiment(cfg, result_dir=result_dir)
    logger = MetricsLogger(result_dir)
    ckpt = CheckpointManager(result_dir, cfg.name)
    head = build_head(cfg, feats.shape[1], device)
    optimizer = build_optimizer(cfg.optimizer, head, cfg.learning_rate)

    x = torch.from_numpy(feats).to(device)
    val_x = torch.from_numpy(val_feats).to(device)

    def indices(idx):
        return torch.as_tensor(np.asarray(idx, np.int64), device=device)

    def step(a_idx, b_idx, learning_rate: float):
        head.train()
        optimizer.zero_grad(set_to_none=True)
        lab = indices(pair_labels(labels, a_idx, b_idx))
        logits, _ = head.score(x[indices(a_idx)], x[indices(b_idx)])
        nll = -torch.log_softmax(logits, dim=-1).gather(1, lab[:, None])
        loss = nll.mean()
        loss.backward()
        apply_gradients(optimizer, learning_rate)
        acc = (logits.argmax(dim=-1) == lab).float().mean()
        return loss.detach(), acc.detach()

    sample_rng = np.random.RandomState(cfg.seed)
    val_a, val_b = prepare_val(val_labels, rng=sample_rng)
    if not val_a:  # clusters of one row: no pair to validate on
        val_a, val_b = [0], [0]
    val_lab = indices(pair_labels(val_labels, val_a, val_b))
    val_a, val_b = indices(val_a), indices(val_b)

    metrics = {}
    steps = 0
    loss = acc = torch.zeros((), device=device)
    try:
        for epoch in range(cfg.max_epochs):
            lr = learning_rate_schedule(epoch, cfg.learning_rate,
                                        cfg.static_epochs, cfg.max_epochs)
            # the negative ratio grows with the epoch
            phase = min(0.5 + epoch / max(cfg.max_epochs, 1), 2.0)
            for a_idx, b_idx in enumerate_batch(labels, NUM_POS, phase,
                                                rng=sample_rng):
                if not a_idx:
                    continue
                loss, acc = step(a_idx, b_idx, lr)
                steps += 1
            head.eval()
            with torch.no_grad():
                logits, _ = head.score(val_x[val_a], val_x[val_b])
                val_acc = float((logits.argmax(dim=-1) == val_lab)
                                .float().mean())
            metrics = {"loss": float(loss), "acc": float(acc),
                       "val_acc": val_acc, "phase": phase}
            logger.log(steps, metrics)
            if not cfg.silent_mode:
                print(f"[{cfg.name}] epoch {epoch + 1} loss "
                      f"{metrics['loss']:.4f} acc {metrics['acc']:.3f} "
                      f"val_acc {val_acc:.3f}")
            ckpt.save(head, optimizer, steps)
    finally:
        logger.close()
    return TrainResult(head, optimizer, steps, metrics, result_dir)


def main(argv=None):
    """The trainer CLI: the JAX trainer's flags, plus ``--device`` (default
    ``cuda``)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default=None)
    args, rest = p.parse_known_args(argv)
    train(TrainConfig.parse(rest), device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
