"""Sensors-only modality hallucination: ``modality_hallucination`` without
the segment branches, with ``lambda_metric`` / ``lambda_hal`` scaling the
triplet and hallucination terms.

Run:  python -m multimodal_similarity_tpu_torch.train.trainers.modality_hallucination_weak --DATA_ROOT <dir> --feat resnet,sensors --lambda_multimodal 0.1 ...
(``--device cpu`` runs on the CPU; the default is ``cuda``.)
"""

from __future__ import annotations

import sys

from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.train.trainers import (
    modality_hallucination)


def train(cfg: TrainConfig, lambda_metric: float = 1.0,
          lambda_hal: float = 1.0, **kw):
    return modality_hallucination.train(
        cfg, sensors_only=True, lambda_metric=lambda_metric,
        lambda_hal=lambda_hal, **kw)


def main(argv=None):
    modality_hallucination.main(argv, sensors_only=True)


if __name__ == "__main__":
    main(sys.argv[1:])
