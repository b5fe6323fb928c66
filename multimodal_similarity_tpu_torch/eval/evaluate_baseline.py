"""No-model retrieval baseline: each event's raw frames mean- or
max-pooled (``--preprocess_func mean | max``), optionally l2-normalised,
then the full leave-one-out retrieval evaluation.  NumPy on the host: no
device work.

Run:  python -m multimodal_similarity_tpu_torch.eval.evaluate_baseline --DATA_ROOT <dir> --feat sensors --preprocess_func max
"""

from __future__ import annotations

import sys

import numpy as np

from multimodal_similarity_tpu_torch.configs import EvalConfig
from multimodal_similarity_tpu_torch.data import (
    load_validation_set, max_pool_input, mean_pool_input, prepare_dataset)
from multimodal_similarity_tpu_torch.eval.metrics import evaluate


def run(cfg: EvalConfig):
    """The baseline's metrics on the test sessions, and the pooled
    ``embeddings`` it evaluated."""
    feat = cfg.feat if isinstance(cfg.feat, str) else cfg.feat[0]
    prep = mean_pool_input if cfg.preprocess_func == "mean" else \
        max_pool_input
    test_set = prepare_dataset(cfg.feature_root, cfg.test_session, feat,
                               cfg.label_root, cfg.label_type)
    feats, labels, _, _ = load_validation_set(test_set, prep,
                                              transfer=cfg.transfer)
    feats = feats.reshape(feats.shape[0], -1)
    if cfg.normalized:
        feats = feats / np.maximum(
            np.linalg.norm(feats, axis=1, keepdims=True), 1e-10)
    mAP, mAP_event, mPrec, confusion, count, recall = evaluate(feats, labels)
    print("mAP = %.4f  mPrec@0.5 = %.4f  Recall@1 = %.4f"
          % (mAP, mPrec, recall[0]))
    return {"mAP": mAP, "mAP_event": mAP_event, "mPrec": mPrec,
            "recall": recall, "embeddings": feats}


def main(argv=None):
    return run(EvalConfig.parse(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
