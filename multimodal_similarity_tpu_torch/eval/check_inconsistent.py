"""Dump a similarity head's confident mistakes on the test sessions.

For every pair (i < j) of each test session's events, scored by the head
of a ``pddm_model`` (``--head pddm``, its ``encoder`` and ``pddm``
groups) or ``pairsim_model`` (``--head pairsim``, ``encoder`` and ``ver``)
checkpoint: false positives, different labels with P(similar) above the
threshold, and false negatives, the same label with P(dissimilar) above
it.  Writes ``inconsistent_<head>.pkl`` beside the checkpoint: {"false_pos",
"false_neg"}, lists of (session, i, j, label_i, label_j, P(similar)) in
row-major pair order.

Run:  python -m multimodal_similarity_tpu_torch.eval.check_inconsistent --head pddm --DATA_ROOT <dir> --model_path <ckpt> --network rtsn --feat sensors --n_input 8 --emb_dim 32 ...
(``--device cpu`` runs on the CPU; the default is ``cuda``.)
"""

from __future__ import annotations

import functools
import os
import pickle
import sys

import numpy as np
import torch

from multimodal_similarity_tpu_torch import resolve_device
from multimodal_similarity_tpu_torch.configs import EvalConfig
from multimodal_similarity_tpu_torch.data import (
    load_data_and_label, prepare_dataset, tsn_prepare_input_test)
from multimodal_similarity_tpu_torch.eval.evaluate_model import load_params
from multimodal_similarity_tpu_torch.models import (
    PDDM, PairSim, build_encoder, score_all_pairs, score_all_pairs_sym)
from multimodal_similarity_tpu_torch.train.checkpoints import (
    restore_encoder_params)
from multimodal_similarity_tpu_torch.train.steps import (
    embed_in_chunks, make_embed_fn)


def run(cfg: EvalConfig, head_kind: str = "pddm", threshold: float = 0.9):
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
    head_cls = PDDM if head_kind == "pddm" else PairSim
    head = load_params(head_cls(n_input=cfg.emb_dim), restore_encoder_params(
        cfg.model_path, cfg.variable_name,
        subkey="pddm" if head_kind == "pddm" else "ver"), device)
    embed = make_embed_fn(encoder, normalized=cfg.normalized)
    # PDDM is swap-invariant: half the head evaluations; PairSim's
    # concatenation order matters, so it scores every ordered pair
    scorer = score_all_pairs_sym if head_kind == "pddm" else score_all_pairs

    false_pos, false_neg = [], []
    for row in test_set:
        eve, lab, _ = load_data_and_label(row[0], row[-1], prep,
                                          cfg.transfer)
        lab = lab.reshape(-1)
        emb = embed_in_chunks(embed, eve, device)
        with torch.no_grad():
            sim = scorer(head.score, emb,
                         block=min(64, emb.shape[0])).cpu().numpy()
        sess_id = os.path.basename(row[0]).split(".")[0].split("_")[0]
        i, j = np.triu_indices(lab.shape[0], 1)
        s = sim[i, j]
        same = lab[i] == lab[j]
        for kind, hit in ((false_pos, ~same & (s > threshold)),
                          (false_neg, same & ((1.0 - s) > threshold))):
            kind.extend((sess_id, int(a), int(b), int(lab[a]), int(lab[b]),
                         float(v))
                        for a, b, v in zip(i[hit], j[hit], s[hit]))

    print(f"{head_kind}: {len(false_pos)} confident false positives, "
          f"{len(false_neg)} confident false negatives "
          f"(threshold {threshold})")
    out_path = os.path.join(os.path.dirname(cfg.model_path),
                            f"inconsistent_{head_kind}.pkl")
    with open(out_path, "wb") as f:
        pickle.dump({"false_pos": false_pos, "false_neg": false_neg}, f)
    return {"false_pos": false_pos, "false_neg": false_neg}


def main(argv=None):
    # --head pairsim|pddm, taken out before EvalConfig parses the rest
    head_kind = "pddm"
    argv = list(argv if argv is not None else sys.argv[1:])
    if "--head" in argv:
        i = argv.index("--head")
        if i + 1 >= len(argv):
            sys.exit("usage: --head {pairsim|pddm} (missing value)")
        head_kind = argv[i + 1]
        del argv[i:i + 2]
    run(EvalConfig.parse(argv), head_kind=head_kind)


if __name__ == "__main__":
    main()
