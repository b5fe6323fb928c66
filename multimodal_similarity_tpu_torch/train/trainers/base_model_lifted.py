"""Lifted-structured loss trainer.

The class-balanced batch loop of the batch-hard trainer
(base_model_batchhard.py) with the lifted-structured objective through the
fused CUDA kernels (ops/kernels/lifted.py): the triangular bounded forward
under the default ``--normalized``, the row forward under
``--no_normalized``, and the recompute backward on every step.

Run:  python -m multimodal_similarity_tpu_torch.train.trainers.base_model_lifted --DATA_ROOT <dir> ...
(``--device cpu`` runs on the CPU; the default is ``cuda``.)
"""

from __future__ import annotations

import sys

from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.train.trainers import (
    base_model_batchhard)


def train(cfg: TrainConfig, **kw):
    return base_model_batchhard.train(cfg, loss_kind="lifted", **kw)


def main(argv=None):
    base_model_batchhard.main(argv, loss_kind="lifted")


if __name__ == "__main__":
    main(sys.argv[1:])
