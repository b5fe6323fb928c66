"""Hallucination evaluation: the core embedding concatenated with the
hallucinated-sensors embedding, both from the video alone and each
l2-normalised, before the leave-one-out retrieval evaluation.

``--model_path`` is a ``modality_hallucination`` checkpoint: its
``modality_core`` scope (emb_dim ``--emb_dim``) and its
``hallucination_sensors`` scope (emb_dim ``BRANCH_EMB_DIM``, 32), both
``--network`` encoders on ``--feat``.  Embeds in chunks on the device.

Run:  python -m multimodal_similarity_tpu_torch.eval.evaluate_hallucination --DATA_ROOT <dir> --model_path <ckpt> --network convrtsn --feat resnet --emb_dim 128 ...
(``--device cpu`` runs on the CPU; the default is ``cuda``.)
"""

from __future__ import annotations

import functools
import sys

import torch

from multimodal_similarity_tpu_torch import resolve_device
from multimodal_similarity_tpu_torch.configs import EvalConfig
from multimodal_similarity_tpu_torch.data import (
    load_validation_set, prepare_dataset, tsn_prepare_input_test)
from multimodal_similarity_tpu_torch.eval.evaluate_model import load_params
from multimodal_similarity_tpu_torch.eval.metrics import evaluate
from multimodal_similarity_tpu_torch.models import (
    BRANCH_EMB_DIM, build_encoder)
from multimodal_similarity_tpu_torch.train.checkpoints import (
    restore_encoder_params)
from multimodal_similarity_tpu_torch.train.steps import (
    embed_in_chunks, make_embed_fn)


def run(cfg: EvalConfig):
    """The fused embedding's metrics on the test sessions, and the
    ``embeddings`` it evaluated."""
    device = resolve_device(cfg.device)
    feat = cfg.feat if isinstance(cfg.feat, str) else cfg.feat[0]
    test_set = prepare_dataset(cfg.feature_root, cfg.test_session, feat,
                               cfg.label_root, cfg.label_type)
    prep = functools.partial(tsn_prepare_input_test, cfg.num_seg)
    feats, labels, _, _ = load_validation_set(test_set, prep,
                                              transfer=cfg.transfer)

    def branch(scope, emb_dim):
        model = build_encoder(cfg.network, num_seg=cfg.num_seg,
                              emb_dim=emb_dim, n_input=cfg.n_input,
                              n_h=cfg.n_h, n_w=cfg.n_w, n_C=cfg.n_C)
        return make_embed_fn(load_params(
            model, restore_encoder_params(cfg.model_path, scope), device))

    core = branch("modality_core", cfg.emb_dim)
    hal = branch("hallucination_sensors", BRANCH_EMB_DIM)
    embeddings = embed_in_chunks(
        lambda x: torch.cat([core(x), hal(x)], dim=1), feats,
        device).cpu().numpy()
    mAP, mAP_event, mPrec, confusion, count, recall = evaluate(
        embeddings, labels)
    print("hallucination fusion: mAP = %.4f  mPrec@0.5 = %.4f  "
          "Recall@1 = %.4f" % (mAP, mPrec, recall[0]))
    return {"mAP": mAP, "mAP_event": mAP_event, "mPrec": mPrec,
            "recall": recall, "embeddings": embeddings}


def main(argv=None):
    run(EvalConfig.parse(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
