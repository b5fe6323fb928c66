"""Checkpoint evaluation: embed the test sessions (test-time TSN centre
frames) and run the full leave-one-out retrieval evaluation.

The encoder is built from the flags and loaded from a port checkpoint
(``train/checkpoints.py``); ``--variable_name`` picks one scope of a
multi-branch checkpoint (e.g. ``modality_core``).  ``--use_output`` takes
a classifier checkpoint (``base_model_classifier``) and uses its logits as
the embedding, the head's width read from the checkpoint.  Embeds in
chunks on the device, prints the metrics and writes ``results.pkl`` beside
the checkpoint.

Run:  python -m multimodal_similarity_tpu_torch.eval.evaluate_model --DATA_ROOT <dir> --model_path <ckpt> --network convrtsn --emb_dim 128 ...
(``--device cpu`` runs on the CPU; the default is ``cuda``.)
"""

from __future__ import annotations

import functools
import os
import pickle
import sys
from typing import Dict

import numpy as np
import torch
from torch import nn

from multimodal_similarity_tpu_torch import resolve_device
from multimodal_similarity_tpu_torch.configs import EvalConfig
from multimodal_similarity_tpu_torch.data import (
    HONDA_NUM2LABELS, load_validation_set, prepare_dataset,
    tsn_prepare_input_test)
from multimodal_similarity_tpu_torch.eval.metrics import evaluate
from multimodal_similarity_tpu_torch.models import (
    ConvTSNClassifier, build_encoder)
from multimodal_similarity_tpu_torch.train.checkpoints import (
    restore_encoder_params)
from multimodal_similarity_tpu_torch.train.steps import (
    embed_in_chunks, l2_normalize)


def load_params(model: nn.Module, params: Dict[str, torch.Tensor],
                device: torch.device) -> nn.Module:
    """``model`` on ``device`` in eval mode, loaded strictly from
    ``params`` (a missing or extra key raises)."""
    model.load_state_dict(params, strict=True)
    return model.to(device).eval()


def run(cfg: EvalConfig, data=None):
    """Evaluate ``cfg.model_path`` on the test sessions (or on ``data``,
    (feats, labels)); returns the results dict it writes, plus the
    ``embeddings`` it evaluated."""
    device = resolve_device(cfg.device)
    feat = cfg.feat if isinstance(cfg.feat, str) else cfg.feat[0]
    if data is None:
        test_set = prepare_dataset(cfg.feature_root, cfg.test_session, feat,
                                   cfg.label_root, cfg.label_type)
        feats, labels, _, _ = load_validation_set(
            test_set, functools.partial(tsn_prepare_input_test, cfg.num_seg),
            transfer=cfg.transfer)
    else:
        feats, labels = data

    params = restore_encoder_params(cfg.model_path, cfg.variable_name)
    if cfg.use_output:
        model = ConvTSNClassifier(
            n_seg=cfg.num_seg, emb_dim=cfg.emb_dim, n_input=cfg.n_input,
            n_h=cfg.n_h, n_w=cfg.n_w, n_C=cfg.n_C,
            n_output=int(params["head.weight"].shape[0]))
    else:
        model = build_encoder(cfg.network, num_seg=cfg.num_seg,
                              emb_dim=cfg.emb_dim, n_input=cfg.n_input,
                              n_h=cfg.n_h, n_w=cfg.n_w, n_C=cfg.n_C)
    model = load_params(model, params, device)

    def embed(x):
        with torch.no_grad():
            e = model(x)[1] if cfg.use_output else model(x)
        return l2_normalize(e) if cfg.normalized else e

    embeddings = embed_in_chunks(embed, feats, device).cpu().numpy()
    mAP, mAP_event, mPrec, confusion, count, recall = evaluate(
        embeddings, labels)

    print("%d events in total" % embeddings.shape[0])
    print("mAP = %.4f" % mAP)
    mAP_macro = float(np.mean(list(mAP_event.values())))
    print("mAP_macro = %.4f" % mAP_macro)
    for key in sorted(mAP_event.keys()):
        name = HONDA_NUM2LABELS.get(key, str(key))
        print("%s: %.4f" % (name, mAP_event[key]))
    print("mPrec@0.5 = %.4f" % mPrec)
    for k, r in zip((1, 2, 4, 8, 16, 32), recall):
        print("Recall@%d = %.4f" % (k, r))

    results = {"mAP": mAP, "mAP_event": mAP_event, "mAP_macro": mAP_macro,
               "mPrec": mPrec, "confusion": confusion, "count": count,
               "recall": recall}
    out_dir = os.path.dirname(cfg.model_path)
    with open(os.path.join(out_dir, "results.pkl"), "wb") as f:
        pickle.dump(results, f)
    return {**results, "embeddings": embeddings}


def main(argv=None):
    run(EvalConfig.parse(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
