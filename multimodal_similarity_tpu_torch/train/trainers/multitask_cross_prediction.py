"""Triplet + cross-modal MSE prediction multitask
(``scripts/train_multitask_cross_prediction.sh``): ``multitask_dcca`` with
``OutputLayer`` heads regressing the frozen sensors and segment embeddings
from the core embedding.  The segment head's target is the segment
embedding.

Run:  python -m multimodal_similarity_tpu_torch.train.trainers.multitask_cross_prediction --DATA_ROOT <dir> --feat resnet,sensors,segment --sensors_path <ckpt> --segment_path <ckpt> ...
(``--device cpu`` runs on the CPU; the default is ``cuda``.)
"""

from __future__ import annotations

import sys

from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.train.trainers import multitask_dcca


def train(cfg: TrainConfig, **kw):
    return multitask_dcca.train(cfg, use_mse=True, **kw)


def main(argv=None):
    multitask_dcca.main(argv, use_mse=True)


if __name__ == "__main__":
    main(sys.argv[1:])
