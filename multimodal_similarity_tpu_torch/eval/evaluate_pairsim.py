"""PairSim verification accuracy on constructed hard and easy triplets.

Per test session: embed its events, then for anchor-positive pairs of each
foreground class draw one semi-hard negative (hard) and one far negative
(easy) from the embedding distances (``select_eval_triplets``), and measure
the PairSim head's accuracy on the (a, p) pairs (similar) and the (a, n)
pairs (dissimilar).  ``--model_path`` is a ``pairsim_model`` checkpoint:
its ``encoder`` and ``ver`` groups.  The draws come from Python's
``random.Random(--seed)``, the stream the JAX CLI draws from.

Run:  python -m multimodal_similarity_tpu_torch.eval.evaluate_pairsim --DATA_ROOT <dir> --model_path <ckpt> --network rtsn --feat sensors --n_input 8 --emb_dim 128 ...
(``--device cpu`` runs on the CPU; the default is ``cuda``.)
"""

from __future__ import annotations

import functools
import itertools
import random
import sys
from typing import List

import numpy as np
import torch

from multimodal_similarity_tpu_torch import resolve_device
from multimodal_similarity_tpu_torch.configs import EvalConfig
from multimodal_similarity_tpu_torch.data import (
    load_data_and_label, prepare_dataset, tsn_prepare_input_test)
from multimodal_similarity_tpu_torch.eval.evaluate_model import load_params
from multimodal_similarity_tpu_torch.models import PairSim, build_encoder
from multimodal_similarity_tpu_torch.ops.chunked_topk import ieee_f32
from multimodal_similarity_tpu_torch.ops.distances import pairwise_distance
from multimodal_similarity_tpu_torch.train.checkpoints import (
    restore_encoder_params)
from multimodal_similarity_tpu_torch.train.steps import (
    embed_in_chunks, make_embed_fn)


def select_eval_triplets(lab, eve_embedding, triplet_per_batch,
                         alpha=0.2, metric="squaredeuclidean",
                         rng=None) -> List[int]:
    """Flat [a, p, n, ...] indices: for each anchor-positive pair, in turn
    over the foreground classes, one negative with dist - pos < alpha and
    pos < dist (hard) and one with dist - pos > alpha (easy), both drawn
    from ``rng`` (Python's ``random`` module by default), until
    ``triplet_per_batch`` triplets of each kind or no pair is left.  The
    distances are one f32 product on the embedding's device (an array
    takes the CPU)."""
    rng = rng or random
    emb = torch.as_tensor(eve_embedding)
    with ieee_f32():
        all_dist = pairwise_distance(emb, emb, metric).cpu().numpy()
    np_lab = np.asarray(lab).reshape(-1)

    idx_dict: dict = {}
    for i, l in enumerate(np_lab):
        idx_dict.setdefault(int(l), []).append(i)
    for key in idx_dict:
        rng.shuffle(idx_dict[key])
    foreground = {k: itertools.permutations(v, 2)
                  for k, v in idx_dict.items() if k != 0}

    triplet_idx: List[int] = []
    while len(triplet_idx) < triplet_per_batch * 3:
        keys = list(foreground.keys())
        if not keys:
            break
        for key in keys:
            try:
                an_idx, pos_idx = next(foreground[key])
            except StopIteration:
                del foreground[key]
                continue
            pos_dist = all_dist[an_idx, pos_idx]
            neg_dist = np.array(all_dist[an_idx], dtype="float64")
            neg_dist[idx_dict[key]] = np.nan
            with np.errstate(invalid="ignore"):
                hard = np.where((neg_dist - pos_dist < alpha)
                                & (pos_dist < neg_dist))[0]
                easy = np.where(neg_dist - pos_dist > alpha)[0]
            if len(hard) > 0 and len(easy) > 0:
                triplet_idx.extend(
                    [an_idx, pos_idx,
                     int(hard[rng.randrange(len(hard))])])
                triplet_idx.extend(
                    [an_idx, pos_idx,
                     int(easy[rng.randrange(len(easy))])])
    return triplet_idx


def run(cfg: EvalConfig):
    """PairSim's accuracy over the test sessions: {"accuracy",
    "per_session", "pairs", "triplets"} (the last, each session's triplet
    indices)."""
    device = resolve_device(cfg.device)
    feat = cfg.feat if isinstance(cfg.feat, str) else cfg.feat[0]
    test_set = prepare_dataset(cfg.feature_root, cfg.test_session, feat,
                               cfg.label_root, cfg.label_type)
    prep = functools.partial(tsn_prepare_input_test, cfg.num_seg)

    encoder = load_params(
        build_encoder(cfg.network, num_seg=cfg.num_seg, emb_dim=cfg.emb_dim,
                      n_input=cfg.n_input, n_h=cfg.n_h, n_w=cfg.n_w,
                      n_C=cfg.n_C),
        restore_encoder_params(cfg.model_path, cfg.variable_name,
                               subkey="encoder"), device)
    head = load_params(PairSim(n_input=cfg.emb_dim), restore_encoder_params(
        cfg.model_path, cfg.variable_name, subkey="ver"), device)
    embed = make_embed_fn(encoder, normalized=cfg.normalized)

    def pair_prob(a, b):
        with torch.no_grad():
            return head.score(a, b)[1].cpu().numpy()

    correct = total = 0
    per_session, triplets = {}, {}
    eval_rng = random.Random(cfg.seed)
    for row in test_set:
        eve, lab, _ = load_data_and_label(row[0], row[-1], prep,
                                          cfg.transfer)
        emb = embed_in_chunks(embed, eve, device)
        tri = select_eval_triplets(lab, emb, 100, alpha=0.2, rng=eval_rng)
        if not tri:
            continue
        tri = np.asarray(tri).reshape(-1, 3)
        a, p, n = (emb[torch.from_numpy(tri[:, i]).to(device)]
                   for i in range(3))
        prob_ap, prob_an = pair_prob(a, p), pair_prob(a, n)
        c = int((prob_ap[:, 1] > 0.5).sum() + (prob_an[:, 1] <= 0.5).sum())
        t = 2 * tri.shape[0]
        sess_id = row[0].split("/")[-1].split(".")[0].split("_")[0]
        per_session[sess_id] = c / t
        triplets[sess_id] = tri
        correct += c
        total += t

    acc = correct / max(total, 1)
    print("PairSim accuracy = %.4f over %d pairs" % (acc, total))
    return {"accuracy": acc, "per_session": per_session, "pairs": total,
            "triplets": triplets}


def main(argv=None):
    run(EvalConfig.parse(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
