"""Standalone PairSim similarity-classifier trainer
(``scripts/train_pairsim_model.sh``).

Each loader batch gives mirrored positive and negative pairs
(``random_pairs``, a copy of the JAX package's host sampler, on the feed
thread with the batch's upload), a train-mode embedding of the paired rows
and the ``PairSim`` head on the un-normalised embeddings, with a masked
cross-entropy.  From epoch ``--negative_epochs`` on, the pairs the model
got confidently wrong (``hard_pairs``: the wrong class above 0.5) are
retrained at once: that pass steps the optimizer, so Adam's count
advances, but not the trainer's global step, which sets the epoch count
and the learning-rate schedule (the reference rolls its global step back
after it).  Per epoch: the accuracy on fixed validation pairs (the first
three validation sessions; all train sessions are used) and a checkpoint
(parameter groups ``encoder`` and ``ver``); at the end the per-pair
``val_results.txt``.  No CUDA kernel of ``csrc/`` is on this path.

Run:  python -m multimodal_similarity_tpu_torch.train.trainers.pairsim_model --DATA_ROOT <dir> --feat sensors --network rtsn --n_input 8 ...
(``--device cpu`` runs on the CPU; the default is ``cuda``.)
"""

from __future__ import annotations

import argparse
import itertools
import os
import random
import sys
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from multimodal_similarity_tpu_torch import resolve_device
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.data.device_feed import device_prefetch
from multimodal_similarity_tpu_torch.models import PairSim
from multimodal_similarity_tpu_torch.train.checkpoints import load_checkpoint
from multimodal_similarity_tpu_torch.train.state import (
    apply_gradients, build_optimizer, l2_regularization,
    learning_rate_schedule)
from multimodal_similarity_tpu_torch.train.steps import (
    embed_in_chunks, make_embed_fn)
from multimodal_similarity_tpu_torch.train.trainer import epoch_of_step
from multimodal_similarity_tpu_torch.train.trainers._honda import (
    HondaExperiment)
from multimodal_similarity_tpu_torch.train.trainers._loop import (
    loader_batches)
from multimodal_similarity_tpu_torch.train.trainers.base_model_batchhard \
    import TrainResult, _check_supported
from multimodal_similarity_tpu_torch.train.trainers.multitask_model import (
    verification_loss)
from multimodal_similarity_tpu_torch.train.trainers.pddm_model import (
    pair_model)

HARD_THRESHOLD = 0.5
PAIR_KEYS = ("pair_idx", "pair_lab", "pair_mask")


def random_pairs(lab, batch_size: int, num_negative: int = 1,
                 test: bool = False,
                 rng=None) -> Tuple[List[int], List[int]]:
    """Mirrored positive/negative pair sampling, a copy of the JAX
    package's: a flat [a, b, a, b, ...] index list and one label a pair
    (``test=True`` draws from ``random.Random(1)``)."""
    rng = random.Random(1) if test else (rng or random)
    np_lab = np.asarray(lab).reshape(-1)
    idx_dict = {}
    for i, l in enumerate(np_lab):
        idx_dict.setdefault(int(l), []).append(i)
    for key in idx_dict:
        rng.shuffle(idx_dict[key])

    foreground = {k: itertools.permutations(v, 2)
                  for k, v in idx_dict.items() if k != 0}
    pair_idx: List[int] = []
    label: List[int] = []
    while len(pair_idx) < batch_size * 2:
        keys = list(foreground.keys())
        if not keys:
            break
        for key in keys:
            try:
                an_idx, pos_idx = next(foreground[key])
            except StopIteration:
                del foreground[key]
                continue
            pair_idx.extend([an_idx, pos_idx, pos_idx, an_idx])
            label.extend([1, 1])
            all_neg = np.where(np_lab != key)[0]
            for _ in range(num_negative):
                neg_idx = int(all_neg[rng.randrange(len(all_neg))])
                pair_idx.extend([an_idx, neg_idx, neg_idx, an_idx])
                label.extend([0, 0])
    return pair_idx, label


def hard_pairs(lab, prob: np.ndarray, threshold: float = 0.9):
    """Confidently-wrong pairs for retraining, a copy of the JAX
    package's: (flat indices into the pair list's rows, labels, count)."""
    lab = np.asarray(lab).reshape(-1)
    pair_idx: List[int] = []
    label: List[int] = []
    hard_pos = np.where(np.logical_and(lab, prob[:, 0] > threshold))[0]
    for idx in hard_pos:
        pair_idx.extend([2 * idx, 2 * idx + 1, 2 * idx + 1, 2 * idx])
        label.extend([1, 1])
    hard_neg = np.where(np.logical_and(lab == 0, prob[:, 1] > threshold))[0]
    for idx in hard_neg:
        pair_idx.extend([2 * idx, 2 * idx + 1, 2 * idx + 1, 2 * idx])
        label.extend([0, 0])
    return pair_idx, label, len(hard_neg) + len(hard_pos)


def _pad_pairs(pair_idx, labels, cap: int):
    """Fix-shape a ragged pair list: [2 cap] indices, [cap] labels, [cap]
    mask."""
    p = min(len(labels), cap)
    idx = np.zeros(2 * cap, np.int64)
    lab = np.zeros(cap, np.int64)
    mask = np.zeros(cap, np.float32)
    idx[: 2 * p] = np.asarray(pair_idx[: 2 * p], np.int64)
    lab[:p] = np.asarray(labels[:p], np.int64)
    mask[:p] = 1.0
    return idx, lab, mask


def make_pairsim_step(model: nn.Module, optimizer,
                      cfg: TrainConfig) -> Callable:
    """step(events, pair_idx [2P], pair_lab [P], pair_mask [P],
    learning_rate) -> device scalars and the pairs' ``prob`` [P, 2]."""

    def step(events, pair_idx, pair_lab, pair_mask, learning_rate: float):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        emb = model.encoder(events[pair_idx])
        pairs = emb.reshape(pair_lab.shape[0], 2, -1)
        logits, prob = model.ver.score(pairs[:, 0], pairs[:, 1])
        ver_loss, acc = verification_loss(logits, pair_lab, pair_mask)
        total = ver_loss
        if cfg.lambda_l2:
            total = total + cfg.lambda_l2 * l2_regularization(model)
        total.backward()
        apply_gradients(optimizer, learning_rate)
        return {"loss": total.detach(), "acc": acc, "prob": prob.detach()}

    return step


def pair_batches(exp: HondaExperiment, cfg: TrainConfig, pair_cap: int,
                 mine_rng: random.Random):
    """One item per loader batch, across epochs, for the feed thread: the
    batch with its padded pairs (and the host pair lists the hard pass
    indexes), or None when the batch has no pair."""
    for b in loader_batches(exp):
        n = int(b["num_events"])
        idx, lab = random_pairs(b["labels"][:n], cfg.batch_size,
                                cfg.num_negative, rng=mine_rng)
        if not lab:
            yield None
            continue
        # the host lists as the padded device batch holds them, so the
        # step's probabilities line up with hard_pairs' indexing
        b["pairs"], b["labels_of_pairs"] = idx[:2 * pair_cap], lab[:pair_cap]
        b.update(zip(PAIR_KEYS, _pad_pairs(idx, lab, pair_cap)))
        yield b


def evaluate_pairs(model: nn.Module, val_x: torch.Tensor, pair_idx,
                   pair_lab, device: torch.device,
                   chunk: int = 65536) -> Tuple[float, np.ndarray]:
    """Accuracy and [P, 2] probabilities of the eval-mode model on fixed
    pairs: the rows embedded once (un-normalised), the head on ``chunk``
    pairs at a time."""
    emb = embed_in_chunks(make_embed_fn(model.encoder, False), val_x,
                          device)
    idx = torch.from_numpy(pair_idx).to(device).reshape(-1, 2)
    model.ver.eval()
    probs = []
    with torch.no_grad():
        for c0 in range(0, idx.shape[0], chunk):
            rows = idx[c0:c0 + chunk]
            probs.append(model.ver.score(emb[rows[:, 0]], emb[rows[:, 1]])[1])
    prob = torch.cat(probs).cpu().numpy() if probs else np.zeros((0, 2))
    acc = float(np.mean(np.argmax(prob, -1) == pair_lab))
    return acc, prob


def write_val_results(path: str, acc: float, prob: np.ndarray, pair_idx,
                      pair_lab) -> None:
    """The per-pair log: label, both probabilities, the two rows."""
    with open(path, "w") as fout:
        fout.write("acc = %.4f\n" % acc)
        fout.write("label\tprob_0\tprob_1\tA_idx\tB_idx\n")
        for i in range(prob.shape[0]):
            fout.write("%d\t%.4f\t%.4f\t%d\t%d\n" % (
                pair_lab[i], prob[i, 0], prob[i, 1], pair_idx[2 * i],
                pair_idx[2 * i + 1]))


def train(cfg: TrainConfig, event_budget: Optional[int] = None,
          result_dir: Optional[str] = None, device=None) -> TrainResult:
    """Train on ``device`` (default ``cuda``; raises when no card is
    visible and the CPU was not asked for).  ``--model_path`` restores a
    port checkpoint (weights, optimizer state and step)."""
    _check_supported(cfg, "pairsim_model", no_cache=True)
    device = resolve_device(device)
    exp = HondaExperiment(cfg, event_budget=event_budget,
                          result_dir=result_dir, limit_label_num=False,
                          val_sessions=cfg.val_session[:3])
    model = pair_model(cfg, "ver", lambda gen, drop: PairSim(
        cfg.emb_dim, cfg.keep_prob, gen, drop), device)
    optimizer = build_optimizer(cfg.optimizer, model, cfg.learning_rate)
    step_host = 0
    if cfg.model_path:
        step_host = load_checkpoint(cfg.model_path, model, optimizer)
    step = make_pairsim_step(model, optimizer, cfg)
    pair_cap = max(cfg.batch_size * 4, 64)

    # fixed validation pairs (the sampler seeded with test=True)
    val_idx, val_lab = random_pairs(exp.val_labels, 1_000_000, test=True)
    val_idx, val_lab, _ = _pad_pairs(val_idx, val_lab, len(val_lab))
    val_x = torch.from_numpy(exp.val_feats).to(device)

    def upload(arrays):
        return [torch.from_numpy(a).to(device) for a in arrays]

    metrics, val_prob = {}, None
    # a config-seeded stream for the pair sampler: the JAX trainer's draws
    mine_rng = random.Random(cfg.seed)
    stream = device_prefetch(pair_batches(exp, cfg, pair_cap, mine_rng),
                             device, device_keys=("events",) + PAIR_KEYS)
    try:
        epoch = epoch_of_step(step_host, exp.batch_per_epoch)
        while epoch < cfg.max_epochs:
            lr = learning_rate_schedule(epoch, cfg.learning_rate,
                                        cfg.static_epochs, cfg.max_epochs)
            step_at_epoch_start = step_host
            for batch in itertools.islice(stream, exp.batch_per_epoch):
                if batch is None:
                    continue  # no pair in this loader draw
                t0 = time.time()
                events = batch["events"]
                aux = step(events, *(batch[k] for k in PAIR_KEYS), lr)
                step_host += 1
                negative_count = 0
                if epoch >= cfg.negative_epochs:
                    pair_lab = batch["labels_of_pairs"]
                    prob = aux["prob"][:len(pair_lab)].cpu().numpy()
                    h_idx, h_lab, negative_count = hard_pairs(
                        np.asarray(pair_lab), prob, HARD_THRESHOLD)
                    if negative_count > 0:
                        h_pairs = np.asarray(batch["pairs"])[h_idx]
                        # steps the optimizer, not the global step
                        step(events, *upload(_pad_pairs(
                            h_pairs.tolist(), h_lab, pair_cap)), lr)
                exp.log_deferred(
                    step_host, {"loss": aux["loss"], "acc": aux["acc"]},
                    {"negative_count": negative_count,
                     "train_time": time.time() - t0, "learning_rate": lr},
                    echo_fn=lambda sc, e=epoch, s=step_host: (
                        f"[{cfg.name}] epoch {e + 1} step {s} loss "
                        f"{sc['loss']:.4f} acc {sc['acc']:.3f}"))
                if exp.control.stop_requested(step_host):
                    break
            exp.flush_logs()
            if exp.preempted(step_host, model, optimizer):
                break
            if step_host == step_at_epoch_start:
                print(f"[{cfg.name}] epoch {epoch + 1}: no trainable batch; "
                      "stopping")
                break
            val_acc, val_prob = evaluate_pairs(model, val_x, val_idx,
                                               val_lab, device)
            metrics = {"val_acc": val_acc}
            exp.log(step_host, metrics,
                    f"[{cfg.name}] epoch {epoch + 1} val acc {val_acc:.4f}")
            exp.save(model, optimizer, step_host)
            epoch = epoch_of_step(step_host, exp.batch_per_epoch)
        if val_prob is not None:
            write_val_results(os.path.join(exp.result_dir,
                                           "val_results.txt"),
                              metrics["val_acc"], val_prob, val_idx, val_lab)
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
