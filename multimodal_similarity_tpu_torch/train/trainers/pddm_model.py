"""PDDM similarity-net trainer on one Honda modality
(``scripts/train_pddm.sh``).

Session batches of a fixed event budget from the session loader, uploaded
on the feed thread (data/device_feed.py).  Each step embeds the whole
budget in eval mode without a gradient, scores every pair of it with the
PDDM head (``score_all_pairs_sym``: PDDM is swap-invariant, so only the
upper-triangle tile pairs are evaluated), mines semi-hard triplets on the
dissimilarity 1 - prob[:, 1] (padding rows and columns at +1e30), re-embeds
the mined rows in train mode, and minimises the PDDM margin loss plus 0.5 x
the triplet loss (``pddm_CUB.pddm_update``).  Per-epoch leave-one-out
validation adds the PDDM-ranking mAP (``val_mAP_PDDM``); the checkpoint
keeps the parameter groups ``encoder`` and ``pddm``.  --bf16_features
ships f32, as the JAX trainer does outside its device cache;
--int8_features raises.  --device_cache gathers each batch from the int8
feature cache inside a fused step (_loop.py ``cache_feed``).  No CUDA
kernel of ``csrc/`` is on this path.

Run:  python -m multimodal_similarity_tpu_torch.train.trainers.pddm_model --DATA_ROOT <dir> --feat sensors --network rtsn --n_input 8 --emb_dim 32 ...
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
from multimodal_similarity_tpu_torch.data.device_feed import (
    dequant_features, take_features)
from multimodal_similarity_tpu_torch.eval.metrics import average_precision
from multimodal_similarity_tpu_torch.models import (
    PDDM, build_encoder, score_all_pairs_sym)
from multimodal_similarity_tpu_torch.ops.mining import mine_semihard_triplets
from multimodal_similarity_tpu_torch.train.checkpoints import load_checkpoint
from multimodal_similarity_tpu_torch.train.state import build_optimizer
from multimodal_similarity_tpu_torch.train.steps import (
    embed_in_chunks, make_embed_fn)
from multimodal_similarity_tpu_torch.train.trainers._honda import (
    HondaExperiment)
from multimodal_similarity_tpu_torch.train.trainers._loop import (
    cache_feed, retrieval_validation, run_budget_trainer)
from multimodal_similarity_tpu_torch.train.trainers.base_model_batchhard \
    import TrainResult, _check_supported
from multimodal_similarity_tpu_torch.train.trainers.pddm_CUB import (
    pddm_update)

_PAD = 1e30


def pair_model(cfg: TrainConfig, head_name: str, make_head: Callable,
               device: torch.device) -> nn.ModuleDict:
    """The encoder of ``cfg`` and the pair head ``make_head(init
    generator, dropout generator)`` as the parameter groups ``encoder`` and
    ``head_name``, named as the JAX params (so ``convert.py`` maps the
    nested flax params by name).  Weights are drawn from ``cfg.seed``; the
    encoder's dropout from ``cfg.seed + 1``, the head's from ``cfg.seed +
    3``."""
    init_gen = torch.Generator().manual_seed(cfg.seed)
    encoder = build_encoder(
        cfg.network, num_seg=cfg.num_seg, emb_dim=cfg.emb_dim,
        n_input=cfg.n_input, n_h=cfg.n_h, n_w=cfg.n_w, n_C=cfg.n_C,
        keep_prob=cfg.keep_prob, generator=init_gen,
        dropout_generator=torch.Generator(device=device).manual_seed(
            cfg.seed + 1))
    head = make_head(init_gen, torch.Generator(device=device).manual_seed(
        cfg.seed + 3))
    return nn.ModuleDict({"encoder": encoder, head_name: head}).to(device)


def make_pddm_step(model: nn.Module, optimizer, cfg: TrainConfig,
                   generator: Optional[torch.Generator]) -> Callable:
    """step(events, labels, mask, learning_rate) -> device scalars:
    semi-hard triplets mined on the PDDM dissimilarity of the budget's
    eval-mode embeddings, then ``pddm_update``.  ``events`` dense or the
    int8 cache's {"q", "scale"}; ``generator`` (on the device) drives the
    mining draws."""
    embed = make_embed_fn(model.encoder, cfg.normalized)

    def step(events, labels: torch.Tensor, mask: torch.Tensor,
             learning_rate: float):
        emb = embed(dequant_features(events))
        with torch.no_grad():
            dmat = 1.0 - score_all_pairs_sym(model.pddm.score, emb,
                                             block=min(128, emb.shape[0]))
        invalid = 1.0 - mask.to(dmat.dtype)
        dmat = dmat + invalid[None, :] * _PAD + invalid[:, None] * _PAD
        mined = mine_semihard_triplets(
            dmat, labels, generator, cfg.triplet_per_batch,
            alpha=cfg.alpha, num_negative=cfg.num_negative, valid=mask)
        tri_idx = torch.cat([mined.anchor, mined.positive, mined.negative])
        aux = pddm_update(model, optimizer, cfg,
                          dequant_features(take_features(events, tri_idx)),
                          mined, learning_rate)
        aux["active_count"] = mined.active_count
        return aux

    return step


def pddm_similarity_matrix(model: nn.Module, feats, device: torch.device,
                           normalized: bool = True,
                           block: int = 128) -> np.ndarray:
    """All-pairs PDDM similarity probabilities of a feature set (eval
    mode), as a host array."""
    emb = embed_in_chunks(make_embed_fn(model.encoder, normalized), feats,
                          device)
    with torch.no_grad():
        sim = score_all_pairs_sym(model.pddm.score, emb,
                                  block=min(block, emb.shape[0]))
    return sim.cpu().numpy()


def mAP_PDDM(sim: np.ndarray, labels: np.ndarray) -> float:
    """The PDDM-ranking mAP: each foreground row ranks every other row by
    its similarity; queries whose AP is undefined are skipped."""
    labels = labels.reshape(-1)
    total, count = 0.0, 0
    for i in range(labels.shape[0]):
        if labels[i] > 0:
            ap = average_precision(np.delete(labels, i) == labels[i],
                                   np.delete(sim[i], i))
            if not np.isnan(ap):
                total += ap
                count += 1
    return total / max(count, 1)


def train(cfg: TrainConfig, event_budget: Optional[int] = None,
          result_dir: Optional[str] = None, device=None) -> TrainResult:
    """Train on ``device`` (default ``cuda``; raises when no card is
    visible and the CPU was not asked for).  ``--model_path`` restores a
    port checkpoint (weights, optimizer state and step)."""
    _check_supported(cfg, "pddm_model")
    device = resolve_device(device)
    exp = HondaExperiment(cfg, event_budget=event_budget,
                          result_dir=result_dir)
    model = pair_model(cfg, "pddm",
                       lambda gen, _: PDDM(cfg.emb_dim, gen), device)
    optimizer = build_optimizer(cfg.optimizer, model, cfg.learning_rate)
    step_host = 0
    if cfg.model_path:
        step_host = load_checkpoint(cfg.model_path, model, optimizer)
    step = make_pddm_step(
        model, optimizer, cfg,
        torch.Generator(device=device).manual_seed(cfg.seed + 2))

    def pddm_map(val_x):
        sim = pddm_similarity_matrix(model, val_x, device, cfg.normalized)
        return {"val_mAP_PDDM": mAP_PDDM(sim, exp.val_labels)}

    return run_budget_trainer(
        cfg, exp, model, optimizer,
        lambda b, epoch, lr: step(b["events"], b["labels"], b["mask"], lr),
        device, step_host,
        retrieval_validation(model.encoder, cfg, exp, device,
                             extra=pddm_map),
        echo_keys=("pddm_loss", "triplet_num"),
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
