"""Hard-mining-only ablation of the flagship multimodal trainer: the
pipeline of ``multimodal_model`` without the structure-mining term.

Run:  python -m multimodal_similarity_tpu_torch.train.trainers.multimodal_model_hardonly --DATA_ROOT <dir> ...
(``--device cpu`` runs on the CPU; the default is ``cuda``.)
"""

from __future__ import annotations

import argparse
import sys

from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.train.trainers.multimodal_model import (
    train as _train)


def train(cfg: TrainConfig, **kw):
    return _train(cfg, hard_only=True, **kw)


def main(argv=None):
    """The trainer CLI: the JAX trainer's flags, plus ``--device`` (default
    ``cuda``)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default=None)
    args, rest = p.parse_known_args(argv)
    cfg = TrainConfig.parse(rest)
    train(cfg, device_mining=cfg.device_mining, device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
